"""Host syncs (stream, device and event synchronises, blocking copies) per
DG cycle inside the program's `dgod.pair` spans (bench/spans.py)."""

from perfbench.bench import spans


def read(ctx):
    return spans.of(ctx).syncs("dgod.pair") if ctx.path == "train" else None
