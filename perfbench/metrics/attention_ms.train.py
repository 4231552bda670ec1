"""Device ms per DG cycle in ViTDet's attention kernels, K7 and K8, by
their files' patterns, in the profiled cycles; None where neither ran."""

from perfbench.bench import readers

KERNELS = ("K7", "K8")


def read(ctx):
    if ctx.path != "train":
        return None
    device_s = ctx.profile.kernel_s()
    s = sum(device_s.get(k, 0.0) for k in KERNELS)
    return readers.per_unit_ms(ctx, s) if s > 0 else None
