"""The union of device intervals per request in the profiled requests, in
ms: what the card itself needs for one predict."""

from perfbench.bench import readers


def read(ctx):
    if ctx.path != "predict" or ctx.profile.busy_s <= 0:
        return None
    return readers.per_unit_ms(ctx, ctx.profile.busy_s)
