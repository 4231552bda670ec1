"""The port's ProcessTrainLoader (data/loader.py) against its TrainLoader
and the JAX package's ProcessTrainLoader.

- over two DG epochs (each batch twice, a reshuffle between) of PNGs and
  JPEGs read through the two packages' DrivingDatasets, the port's process
  loader yields the batches of its thread loader and of JAX's process
  loader, bit for bit; with a mesh rank's `rows=` block it yields the
  thread loader's rows;
- a child that reports an error, and one that dies, raise RuntimeError in
  the parent within the loader's poll time (POLL_S, 5 s) and 10 s more;
- `close()` leaves no live child and no shared memory;
- the modules a child imports import no torch (its start-up).

Six children are spawned here (two in the first test, one in the second,
two in the third, one in the fourth), ~2 s each.
"""

import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from dgod_tpu.data import dataset as j_dataset
from dgod_tpu.data import loader as j_loader
from dgod_tpu.data import transforms as j_T
from dgod_tpu_torch.data import dataset as t_dataset
from dgod_tpu_torch.data import loader as t_loader
from dgod_tpu_torch.data import transforms as t_T

SMALL = dict(CANVAS=(64, 128), TRAIN_SIZE=(60, 120), MIN_SIZE=60,
             MAX_SIZE=120, MIN_AREA=4.0)


@pytest.fixture
def files(tmp_path, monkeypatch):
    """Two domains of 6 images each, PNG and JPEG by turns (written by
    cv2), with CSVs; both packages' transforms at 64x128."""
    for module in (j_T, t_T):
        for k, v in SMALL.items():
            monkeypatch.setattr(module, k, v)
    rng = np.random.RandomState(0)
    out = []
    for d in range(2):
        rows = []
        for i in range(6):
            h, w = rng.randint(50, 90), rng.randint(90, 180)
            name = f"d{d}_{i}." + ("png" if i % 2 else "jpg")
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            assert cv2.imwrite(str(tmp_path / name), img)
            n = rng.randint(1, 4)
            boxes = ";".join(f"{x} {y} {x + 20} {y + 15}" for x, y in zip(
                rng.randint(0, w - 20, n), rng.randint(0, h - 15, n)))
            labels = ";".join(str(v) for v in rng.randint(1, 9, n))
            rows.append(f"{name},{boxes},{labels}")
        csv = tmp_path / f"d{d}.csv"
        csv.write_text("image_name,BoxesString,LabelsString\n"
                       + "\n".join(rows) + "\n")
        out.append((str(csv), str(tmp_path) + "/", d))
    return out


def _concat(module, files):
    return module.ConcatDataset([module.DrivingDataset(*f) for f in files])


def _epochs(loader, n=2):
    try:
        return [b for _ in range(n) for b in loader.epoch()]
    finally:
        if hasattr(loader, "close"):
            loader.close()


def _assert_same(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_process_loader_matches_thread_loader_and_jax(files):
    kw = dict(batch_size=3, dg=True, seed=5, num_workers=2)
    got = _epochs(t_loader.ProcessTrainLoader(_concat(t_dataset, files),
                                              **kw))
    assert len(got) == 2 * 8  # 12 images, batches of 3, each twice
    _assert_same(got, _epochs(t_loader.TrainLoader(_concat(t_dataset, files),
                                                   **kw)))
    _assert_same(got, _epochs(j_loader.ProcessTrainLoader(
        _concat(j_dataset, files), **kw)))
    # the duplicate batch replays the same pixels, and epoch 2 reshuffles
    assert all(np.array_equal(got[i]["image"], got[i + 1]["image"])
               for i in range(0, len(got), 2))
    assert not np.array_equal(got[0]["image"], got[8]["image"])


def test_process_loader_rows_are_the_thread_loaders(files):
    kw = dict(batch_size=3, dg=True, seed=5, num_workers=2)
    process = t_loader.ProcessTrainLoader(_concat(t_dataset, files), **kw)
    process.rows = (1, 3)  # as the harness sets a mesh rank's block
    got = _epochs(process)
    ref = _epochs(t_loader.TrainLoader(_concat(t_dataset, files), rows=(1, 3),
                                       **kw))
    _assert_same(got, ref)
    assert got[0]["image"].shape[0] == 2


def test_a_failing_child_raises_in_time(files, tmp_path):
    missing = tmp_path / "missing.csv"
    missing.write_text("image_name,BoxesString,LabelsString\n"
                       + "".join(f"nope{i}.png,1 1 5 5,1\n" for i in range(4)))
    broken = t_dataset.DrivingDataset(str(missing), str(tmp_path) + "/", 0)
    loader = t_loader.ProcessTrainLoader(broken, 2, dg=False)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        next(loader.epoch())
    assert time.monotonic() - t < 60
    loader.close()

    loader = t_loader.ProcessTrainLoader(_concat(t_dataset, files), 3,
                                         dg=False, num_workers=2)
    batches = loader.epoch()
    next(batches)
    for _ in range(loader.n_slots):  # the child waits for a free slot
        loader._full_q.get(timeout=30)
    loader._proc.kill()
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="died"):
        for _ in range(4):
            next(batches)
    assert time.monotonic() - t < t_loader.POLL_S + 10
    loader.close()


def test_close_leaves_no_child(files):
    loader = t_loader.ProcessTrainLoader(_concat(t_dataset, files), 3,
                                         dg=True, num_workers=2)
    next(loader.epoch())
    proc, names = loader._proc, [m.name for m in loader._shms]
    assert proc.is_alive() and len(names) == loader.n_slots
    loader.close()
    assert not proc.is_alive()
    assert proc not in multiprocessing.active_children()
    assert not [n for n in names if os.path.exists(f"/dev/shm/{n}")]
    loader.close()  # twice is harmless


def test_the_childs_modules_import_no_torch():
    code = ("import sys\n"
            "import dgod_tpu_torch.data.loader, dgod_tpu_torch.data.dataset\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
