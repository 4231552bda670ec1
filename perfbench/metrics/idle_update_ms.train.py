"""Device-idle ms per DG cycle inside the optimizer's `dgod.update` spans,
in a pass that records the host's operations (bench/spans.py)."""

from perfbench.bench import spans


def read(ctx):
    return spans.of(ctx).idle_ms("dgod.update") if ctx.path == "train" \
        else None
