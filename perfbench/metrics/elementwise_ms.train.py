"""Device ms per DG cycle in the elementwise / copy kernels (frozen
CATEGORIES) of the profiled cycles."""

from perfbench.bench import readers


def read(ctx):
    s = ctx.profile.category_s().get(ctx.kernels.ELEMENTWISE)
    return readers.per_unit_ms(ctx, s) if s else None
