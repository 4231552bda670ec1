"""Helpers of the split scripts (`scripts/time_*_parts.py`): build edited
copies of the port's CUDA sources and time them in turns on the card.

A script names its copies as {source: {name: [(old, new), ...]}}: each copy
is `dgod_tpu_torch/csrc/<source>.cu` with every `old` text replaced by its
`new` one (a copy whose text is gone from the source stops the script).
`build` compiles every copy at once (one nvcc each) under
`dgod_tpu_torch/_build/parts/`; `use` points the wrappers at one copy's
library; `rounds` times every copy of a source on each named call, in
turns over three rounds, with CUDA events queued behind a device sleep
(`dgod_tpu_torch.utils.timing.device_time_ms`). Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# the split scripts build their inputs with chip_smoke's helpers
import chip_smoke as cs  # noqa: E402,F401
from dgod_tpu_torch.ops import _build  # noqa: E402
from dgod_tpu_torch.ops import (cuda_matchers, cuda_nms,  # noqa: E402
                                cuda_proposals, cuda_roi_align)
from dgod_tpu_torch.utils import timing  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "parts"


def card() -> None:
    """Print the card's name and power limit."""
    print(timing.card("cuda"))


def build(variants, extra=None):
    """Compile every copy of `variants`, and the whole texts of `extra`
    ({source: {name: text}}), all at once; print each copy's registers.
    -> {source: [names]}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    names = {}
    for source, copies in variants.items():
        src = (_build.CSRC / f"{source}.cu").read_text()
        texts = {}
        for name, edits in copies.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"{source} {name}: the source no longer "
                                     f"has the text this copy edits")
                text = text.replace(old, new)
            texts[name] = text
        texts.update((extra or {}).get(source, {}))
        names[source] = list(texts)
        for name, text in texts.items():
            stem = OUT_DIR / f"{source}_{name}"
            stem.with_suffix(".cu").write_text(text)
            procs[source, name] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")),
                 str(stem.with_suffix(".cu"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (source, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {source} {name}:\n{log}")
        regs = [line.split("info    :")[-1].strip() for line in
                log.splitlines() if "registers" in line]
        print(f"{source} {name}: {'; '.join(regs)}")
    return names


def use(source: str, name=None) -> None:
    """The wrappers load the copy's library from now on (the built source's
    with no name)."""
    if name is None:
        _build._loaded.pop(source, None)
    else:
        _build._loaded[source] = ctypes.CDLL(
            str(OUT_DIR / f"{source}_{name}.so"))
    cuda_roi_align._fns.clear()
    cuda_matchers._fn = None
    cuda_matchers._fcos_fn = None
    cuda_nms._fn = None
    cuda_proposals._fn = None


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def rounds(source, names, calls, after_base=()):
    """Times of every copy of `source` in `names` on each named call, in
    turns over three rounds; the first round also compares outputs with
    base's. A copy in `after_base` is timed right after a call of base (its
    input: what base left in the allocator's memory)."""
    use(source, "base")
    refs = {label: fn() for label, fn in calls.items()}
    times = {(name, label): [] for name in names for label in calls}
    for rnd in range(3):
        for name in names:
            for label, fn in calls.items():
                if name in after_base:
                    use(source, "base")
                    fn()
                use(source, name)
                if rnd == 0:
                    same = all(torch.equal(a, b) for a, b in
                               zip(_as_list(fn()), _as_list(refs[label])))
                    print(f"{source} {name} on {label}: the same output as "
                          f"base: {same}")
                times[name, label].append(
                    timing.device_time_ms(fn, "cuda", iters=20))
    use(source)
    for (name, label), t in times.items():
        print(f"{source} {name:14s} {label:10s} ms: "
              + " ".join(f"{x:.4f}" for x in t))
