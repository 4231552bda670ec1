"""Kernel launches per DG cycle inside the program's `dgod.vit.window` and
`dgod.vit.global` spans (ViTDet's blocks, forward), on any thread
(bench/spans.py); None where the program has neither span."""

from perfbench.bench import spans


def read(ctx):
    if ctx.path != "train":
        return None
    reading = spans.of(ctx)
    counts = [reading.launches(n) for n in ("dgod.vit.window",
                                            "dgod.vit.global")]
    counts = [c for c in counts if c is not None]
    return sum(counts) if counts else None
