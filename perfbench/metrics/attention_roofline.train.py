"""K7 and K8's bounds over their launches in the profiled DG cycles, over
their device time there, in % (bench/kernels.py, perfbench/kernels/K7.py
and K8.py); None where neither ran or the program has no counters for
them."""

KERNELS = ("K7", "K8")


def read(ctx):
    if ctx.path != "train":
        return None
    device_s = ctx.profile.kernel_s()
    total_s = sum(device_s.get(k, 0.0) for k in KERNELS)
    launched = {k: ctx.launches.get(k, 0) for k in KERNELS}
    if total_s <= 0 or not any(launched.values()):
        return None
    bound = sum(n * ctx.kernels.bound_s(k, ctx.path, ctx.config, ctx.s.batch,
                                        ctx.s.max_gt)
                for k, n in launched.items() if n)
    return 100.0 * bound / total_s
