"""Device-idle ms per DG cycle inside the program's `dgod.forward` spans,
in a pass that records the host's operations (bench/spans.py)."""

from perfbench.bench import spans


def read(ctx):
    return spans.of(ctx).idle_ms("dgod.forward") if ctx.path == "train" \
        else None
