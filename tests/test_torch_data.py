"""The port's data path against the JAX package's, on the same files.

- the CSV read with the stdlib (no pandas) gives the annotations JAX's
  DrivingDataset (pandas) gives, on rows with `no_box`, empty cells,
  several boxes, negative and fractional values, and a label column that
  pandas reads as integers or as floats;
- the stdlib PNG reader equals `cv2.imread` (RGB) for each of the five
  filter types, for RGBA, for a PNG cv2 wrote, and for the port's writer;
- the C++ prep is within 1 LSB of cv2 and equal to the JAX package's C++;
- TrainLoader (dg and non-dg, replay resampled or not) and EvalLoader (tail
  padding, pad_to_batches) yield the arrays of the JAX loaders for the same
  seed and files.
"""

import csv
import sys
import struct
import zlib

import numpy as np
import pytest

import dgod_tpu.data.dataset as j_dataset
import dgod_tpu.data.loader as j_loader
import dgod_tpu.data.native as j_native
import dgod_tpu.data.transforms as j_T
from dgod_tpu_torch.data import dataset as t_dataset
from dgod_tpu_torch.data import loader as t_loader
from dgod_tpu_torch.data import native as t_native
from dgod_tpu_torch.data import png
from dgod_tpu_torch.data import transforms as t_T

cv2 = pytest.importorskip("cv2")

CSV_CASES = {
    "mixed": [
        ("a.png", "10 20 30 40;-5 3 12.7 9;1 1 2 2", "1;2;3"),
        ("b.png", "no_box", "no_label"),
        ("c.png", "", ""),
        ("d.png", "100 200 300 400", "7"),
        ("e.png", "5 5 6", "2"),  # malformed box: three values
    ],
    # every label cell one integer: pandas reads an int column
    "int_labels": [("a.png", "1 2 3 4", "3"), ("b.png", "5 6 7 8", "4")],
    # ... and with an empty cell a float column ('3.0'), which decodes to
    # no labels, in both packages
    "float_labels": [("a.png", "1 2 3 4", "3"), ("b.png", "", ""),
                     ("c.png", "-1 -2 30 40", "5")],
}


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_name", "BoxesString", "LabelsString"])
        w.writerows(rows)


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_annotations_match_jax(tmp_path, case):
    path = str(tmp_path / "ann.csv")
    _write_csv(path, CSV_CASES[case])
    ref = j_dataset.DrivingDataset(path, str(tmp_path) + "/", 0)
    got = t_dataset.DrivingDataset(path, str(tmp_path) + "/", 0)
    assert got.image_names == ref.image_names
    assert len(got.boxes) == len(ref.boxes)
    for a, b in zip(got.boxes, ref.boxes):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape == b.shape
    for a, b in zip(got.labels, ref.labels):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape == b.shape


# -- PNG -----------------------------------------------------------------------

def _filtered_png(img, kinds):
    """Encode `img` ([H, W, C] uint8, C 3 or 4) as a PNG whose row y uses
    filter kinds[y % len(kinds)]: the encoder side of each PNG filter."""
    h, w, c = img.shape
    data = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        x = data[y]
        up = data[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int32), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        rows.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8)
                    .tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    colour = {3: 2, 4: 6}[c]
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


PNG_CASES = {f"filter{k}": ((k,), 3) for k in range(5)}
PNG_CASES["all_filters_rgba"] = ((0, 1, 2, 3, 4), 4)


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_reader_matches_cv2(tmp_path, case):
    kinds, channels = PNG_CASES[case]
    rng = np.random.RandomState(len(case))
    img = rng.randint(0, 256, (13, 21, channels)).astype(np.uint8)
    img[4:9, 3:15] = 200  # flat patches make the filters' sums wrap
    path = tmp_path / "x.png"
    path.write_bytes(_filtered_png(img, kinds))
    np.testing.assert_array_equal(png.read_png(str(path)), _cv2_rgb(path))
    np.testing.assert_array_equal(png.read_png(str(path)), img[..., :3])


def test_png_reader_reads_cv2_and_its_own_files(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (40, 70, 3)).astype(np.uint8)
    img[10:30, 20:50] = (30, 200, 90)
    path = tmp_path / "cv2.png"
    assert cv2.imwrite(str(path), img[..., ::-1])  # cv2 writes BGR
    np.testing.assert_array_equal(png.read_png(str(path)), img)
    own = tmp_path / "own.png"
    png.write_png(str(own), img)
    np.testing.assert_array_equal(_cv2_rgb(own), img)
    with pytest.raises(ValueError, match="cv2"):
        gray = tmp_path / "gray.png"
        assert cv2.imwrite(str(gray), img[..., 0])
        png.read_png(str(gray))


# -- the C++ image prep ---------------------------------------------------------

@pytest.mark.parametrize("src_hw,resized,flip", [
    ((257, 513), (120, 240), False), ((257, 513), (120, 240), True),
    ((60, 100), (97, 161), True)])
def test_native_prep_matches_cv2_and_jax(monkeypatch, src_hw, resized, flip):
    rng = np.random.RandomState(sum(src_hw))
    src = rng.randint(0, 256, (*src_hw, 3)).astype(np.uint8)
    canvas = (128, 256) if resized[0] <= 128 else (104, 168)
    got = t_native.prepare_image_native(src, canvas, resized, flip)
    ref = t_native.prepare_image_cv2(src, canvas, resized, flip)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert not got[resized[0]:].any() and not got[:, resized[1]:].any()
    monkeypatch.setenv("DGOD_IMAGE_PREP", "native")
    np.testing.assert_array_equal(
        got, j_native.prepare_image(src, canvas, resized, flip))


# -- loaders ------------------------------------------------------------------

SMALL = dict(CANVAS=(64, 128), TRAIN_SIZE=(60, 120), MIN_SIZE=60,
             MAX_SIZE=120, MIN_AREA=4.0)


@pytest.fixture
def files(tmp_path, monkeypatch):
    """Two domains of PNGs and CSVs; both packages' transforms at 64x128."""
    for module in (j_T, t_T):
        for k, v in SMALL.items():
            monkeypatch.setattr(module, k, v)
    rng = np.random.RandomState(0)
    out = []
    for d in range(2):
        rows = []
        for i in range(7):
            h, w = rng.randint(50, 90), rng.randint(90, 180)
            name = f"d{d}_{i}.png"
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            assert cv2.imwrite(str(tmp_path / name), img)
            n = rng.randint(0, 4)
            boxes = ";".join(f"{x} {y} {x + 20} {y + 15}" for x, y in zip(
                rng.randint(0, w - 20, n), rng.randint(0, h - 15, n)))
            rows.append((name, boxes or "no_box",
                         ";".join(str(v) for v in rng.randint(1, 9, n))
                         or "no_label"))
        _write_csv(tmp_path / f"d{d}.csv", rows)
        out.append((str(tmp_path / f"d{d}.csv"), str(tmp_path) + "/", d))
    return out


def _concat(module, files):
    return module.ConcatDataset([module.DrivingDataset(*f) for f in files])


def _assert_same_batches(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dg,resample", [(False, False), (True, False),
                                         (True, True)])
def test_train_loader_matches_jax(files, dg, resample):
    kw = dict(batch_size=3, dg=dg, seed=5, num_workers=2,
              resample_replay=resample)
    got_loader = t_loader.TrainLoader(_concat(t_dataset, files), **kw)
    ref_loader = j_loader.TrainLoader(_concat(j_dataset, files), **kw)
    for _ in range(2):  # the second epoch reshuffles
        got = list(got_loader.epoch())
        ref = list(ref_loader.epoch())
        _assert_same_batches(got, ref)
    assert len(got) == got_loader.steps_per_epoch() == (8 if dg else 4)
    if dg:  # the duplicate batch: the same images, flipped alike or not
        same = [np.array_equal(got[i]["image"], got[i + 1]["image"])
                for i in range(0, len(got), 2)]
        assert all(same) != resample


@pytest.mark.parametrize("resize,pad_to", [(False, None), (True, 6)])
def test_eval_loader_matches_jax(files, resize, pad_to):
    kw = dict(batch_size=4, resize_to_train_size=resize, num_workers=2,
              pad_to_batches=pad_to)
    got = list(t_loader.EvalLoader(_concat(t_dataset, files), **kw))
    ref = list(j_loader.EvalLoader(_concat(j_dataset, files), **kw))
    _assert_same_batches(got, ref)
    assert got[3]["num_real"] == 2  # 14 images in batches of 4
    assert len(got) == (pad_to or 4)


def test_without_cv2_the_port_reads_pngs_and_resizes_with_cpp(files,
                                                              monkeypatch):
    """The card's machine has no OpenCV: images then come through the
    stdlib PNG reader (cv2 wrote these, with its own choice of filters)
    and the C++ prep, within 1 LSB of the OpenCV path."""
    kw = dict(batch_size=4, resize_to_train_size=True, num_workers=2)
    ref = list(t_loader.EvalLoader(_concat(t_dataset, files), **kw))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    got = list(t_loader.EvalLoader(_concat(t_dataset, files), **kw))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        diff = np.abs(a["image"].astype(int) - b["image"].astype(int))
        assert diff.max() <= 1
        for k in a.keys() - {"image"}:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
