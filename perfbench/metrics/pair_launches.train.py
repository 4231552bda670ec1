"""Kernel launches per DG cycle inside the program's `dgod.pair` spans, on
any thread (bench/spans.py)."""

from perfbench.bench import spans


def read(ctx):
    return spans.of(ctx).launches("dgod.pair") if ctx.path == "train" \
        else None
