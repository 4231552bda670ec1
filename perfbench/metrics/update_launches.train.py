"""Kernel launches per DG cycle inside the optimizer's `dgod.update` spans
(bench/spans.py)."""

from perfbench.bench import spans


def read(ctx):
    return spans.of(ctx).launches("dgod.update") if ctx.path == "train" \
        else None
