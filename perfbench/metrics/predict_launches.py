"""Kernel launches per request inside the program's `dgod.predict` spans
(bench/spans.py)."""

from perfbench.bench import spans


def read(ctx):
    return spans.of(ctx).launches("dgod.predict") if ctx.path == "predict" \
        else None
