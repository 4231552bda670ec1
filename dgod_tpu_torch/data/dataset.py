"""CSV-driven driving-scene detection dataset, host side (the port's own
copy of dgod_tpu/data/dataset.py).

Parity with the reference DrivingDataset (DrivingDataset.py:7-105):
- CSV schema `image_name, BoxesString, LabelsString` with ';'-separated
  'x1 y1 x2 y2' boxes and `no_box` / `no_label` sentinels,
- eager decode of all annotation strings at init,
- malformed rows degrade to empty annotations (DrivingDataset.py:85-88,102-105),
- box decode casts to int and clips at 0 (DrivingDataset.py:101),
- the BDD sanitisation clips applied per image at load time
  (DrivingDataset.py:41-48).

The CSV is read with the stdlib `csv` module (pandas is not needed); each
cell becomes the string `str()` gives of what `pandas.read_csv` makes of it
(`pandas_cell_strings`), so the annotations decode as the JAX package
decodes them. Images load through OpenCV (BGR -> RGB) where cv2 imports,
as the reference does, and otherwise through the port's own readers,
chosen by the file's first bytes: PNG (`png.decode_png`) or baseline JPEG
(`jpeg.decode_jpeg`), both of which give what cv2 gives, bit for bit.
"""

from __future__ import annotations

import csv
import threading
from typing import List, Sequence

import numpy as np

# the strings pandas.read_csv reads as NaN by default
_NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def _all_parse(values, fn) -> bool:
    try:
        for v in values:
            fn(v)
    except ValueError:
        return False
    return True


def pandas_cell_strings(cells: Sequence[str]) -> List[str]:
    """`[str(v) for v in pd.read_csv(...)[column]]` for one column's raw
    cells: a column of integers stays integer ('3'), unless a cell is
    missing, which makes it float ('3.0', and 'nan' for the missing cell);
    a column of numbers is float; any other column keeps its text, with
    'nan' for each missing cell."""
    missing = [c in _NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if present and not any(missing) and _all_parse(present, int):
        return [str(int(c)) for c in cells]
    if _all_parse(present, float):
        return ["nan" if m else str(float(c)) for c, m in zip(cells, missing)]
    return ["nan" if m else c for c, m in zip(cells, missing)]


def read_annotation_csv(path: str):
    """-> (image names, box strings, label strings), as pandas gives them."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    header, body = rows[0], rows[1:]
    cols = {}
    for name in ("image_name", "BoxesString", "LabelsString"):
        if name not in header:
            raise ValueError(f"{path}: no column {name!r} (has {header})")
        i = header.index(name)
        cols[name] = pandas_cell_strings(
            [r[i] if i < len(r) else "" for r in body])
    return cols["image_name"], cols["BoxesString"], cols["LabelsString"]


def decode_boxes_string(s) -> np.ndarray:
    """'x1 y1 x2 y2;...' -> [N, 4] float32 of int-truncated values clipped
    at 0. A string that is not boxes of four numbers ('no_box', an empty
    cell read as 'nan', three values) gives no boxes, as the JAX package's
    C++ parser (the one its DrivingDataset uses) gives."""
    s = str(s)
    if s == "no_box":
        return np.zeros((0, 4), np.float32)
    try:
        boxes = np.array(
            [[float(v) for v in box.split(" ")] for box in s.split(";")]
        )
    except ValueError:
        return np.zeros((0, 4), np.float32)
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        return np.zeros((0, 4), np.float32)
    return boxes.astype(np.int32).clip(min=0).astype(np.float32)


def decode_labels_string(s) -> np.ndarray:
    s = str(s)
    if s == "no_label":
        return np.zeros((0,), np.int32)
    try:
        return np.array([int(v) for v in s.split(";")], np.int32)
    except Exception:
        return np.zeros((0,), np.int32)


def sanitize_boxes(boxes: np.ndarray, height: int, width: int) -> np.ndarray:
    """BDD-style fixups (reference DrivingDataset.py:41-48)."""
    if len(boxes) == 0:
        return boxes
    boxes = boxes.copy()
    boxes[:, 0] = np.clip(boxes[:, 0], 0, width - 1)
    boxes[:, 1] = np.clip(boxes[:, 1], 0, height - 1)
    boxes[:, 2] = np.clip(boxes[:, 2], 1, width - 1)
    boxes[:, 3] = np.clip(boxes[:, 3], 1, height - 1)
    eq_x = boxes[:, 0] == boxes[:, 2]
    eq_y = boxes[:, 1] == boxes[:, 3]
    boxes[eq_x, 0] -= 1
    boxes[eq_y, 1] -= 1
    return boxes


def load_rgb(path: str) -> np.ndarray:
    """An image file -> RGB uint8 [H, W, 3]: OpenCV where it imports, else
    the PNG or JPEG reader that the file's signature names."""
    try:
        import cv2
    except ImportError:
        from . import jpeg, png

        with open(path, "rb") as f:
            data = f.read()
        if data.startswith(png.SIGNATURE):
            return png.decode_png(data, path)
        if data.startswith(jpeg.SIGNATURE):
            return jpeg.decode_jpeg(data, path)
        raise ValueError(f"{path}: neither a PNG nor a JPEG file; without "
                         "cv2 the port reads those two formats only")
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class DrivingDataset:
    """Map-style dataset over one domain's CSV.

    `decode_cache_bytes` > 0 enables a decoded-image RAM cache: the first
    epoch pays the image decode, later epochs serve read-only arrays from
    memory. The cache fills until the byte budget and then stops (epoch
    order is a fresh uniform shuffle, so eviction has no hit-rate advantage
    over fill-and-freeze, and a frozen cache needs no lock on the hit
    path). The reference re-decodes every image every epoch in its
    DataLoader workers (DrivingDataset.py:35-36, DGcommon.py:151).
    """

    def __init__(self, csv_file: str, root: str, domain: int,
                 decode_cache_bytes: int = 0):
        names, box_strings, label_strings = read_annotation_csv(csv_file)
        self.image_names: List[str] = names
        self.root = root
        # eager decode like the reference (DrivingDataset.py:22-23)
        self.boxes = [decode_boxes_string(s) for s in box_strings]
        self.labels = [decode_labels_string(s) for s in label_strings]
        self.domain = domain
        self._cache_budget = int(decode_cache_bytes)
        self._cache: dict = {}
        self._cache_used = 0
        self._cache_lock = threading.Lock()

    def __getstate__(self):
        # a loader's child process gets the annotations, not the parent's
        # cache (it fills its own) or its lock
        state = dict(self.__dict__)
        state["_cache"] = {}
        state["_cache_used"] = 0
        del state["_cache_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._cache_lock = threading.Lock()

    def __len__(self):
        return len(self.image_names)

    def load_image(self, idx: int) -> np.ndarray:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        img = load_rgb(self.root + self.image_names[idx])
        if self._cache_budget > 0:
            with self._cache_lock:
                if idx not in self._cache and (
                        self._cache_used + img.nbytes <= self._cache_budget):
                    img.flags.writeable = False  # shared across threads
                    self._cache[idx] = img
                    self._cache_used += img.nbytes
        return img

    def __getitem__(self, idx: int):
        img = self.load_image(idx)
        boxes = sanitize_boxes(self.boxes[idx], img.shape[0], img.shape[1])
        return img, boxes, self.labels[idx].copy(), self.domain


class SyntheticDataset:
    """In-memory dataset with generated images — test stand-in."""

    def __init__(self, n: int, domain: int = 0, image_hw=(128, 256),
                 num_classes: int = 8, max_boxes: int = 6, seed: int = 0):
        rng = np.random.RandomState(seed + domain)
        h, w = image_hw
        self.images = [
            rng.randint(0, 255, (h, w, 3), np.uint8) for _ in range(n)
        ]
        self.boxes, self.labels = [], []
        for _ in range(n):
            k = rng.randint(1, max_boxes + 1)
            xy = rng.uniform([0, 0], [w * 0.6, h * 0.6], (k, 2))
            wh = rng.uniform([w * 0.1, h * 0.1], [w * 0.35, h * 0.35], (k, 2))
            b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            self.boxes.append(b)
            self.labels.append(
                rng.randint(1, num_classes + 1, k).astype(np.int32))
        self.domain = domain

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        return (
            self.images[idx].copy(),
            self.boxes[idx].copy(),
            self.labels[idx].copy(),
            self.domain,
        )


class Subset:
    """A contiguous [start, stop) view of a dataset."""

    def __init__(self, dataset, start: int, stop: int):
        if not 0 <= start <= stop <= len(dataset):
            raise ValueError(f"Subset [{start}, {stop}) of a dataset of "
                             f"{len(dataset)}")
        self.dataset = dataset
        self.start = int(start)
        self.stop = int(stop)

    def __len__(self):
        return self.stop - self.start

    def __getitem__(self, idx: int):
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        return self.dataset[self.start + idx]


class ConcatDataset:
    """Concatenation of per-domain datasets (torch ConcatDataset parity)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1]) if len(self.datasets) else 0

    def __getitem__(self, idx: int):
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self.cum[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]
