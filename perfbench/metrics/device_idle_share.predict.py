"""1 - the union of device intervals over the wall span of the profiled
requests, in %."""


def read(ctx):
    return 100.0 * ctx.profile.idle_share if ctx.path == "predict" else None
