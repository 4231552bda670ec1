"""Batch loaders with the DG twice-per-batch sampler, threaded decode, and
the copy of batches to the card (the port's own copy of
dgod_tpu/data/loader.py, less ProcessTrainLoader).

A loader may be given a row block (`rows=(start, stop)`): it then yields
only those rows of every batch. It keeps the order and the per-image
augmentation seeds of the whole batch, so the row blocks of the ranks of a
mesh (parallel/mesh.py::Mesh.row_block) put together are the one-device
batch, bit for bit, and no rank decodes an image it does not use.

Parity: the reference's custom train_dataloader (DGcommon.py:139-151)
shuffles indices, chunks them into batches, and in 'dg' mode emits every
batch twice consecutively so the mode-0 and mode-k steps of the 5-mode
schedule see the same images. Host parallelism uses a thread pool (OpenCV,
the C++ prep and zlib release the GIL) standing in for the reference's 4
DataLoader workers (DGcommon.py:151).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator, Optional

import numpy as np
import torch

from . import transforms as T


def device_prefetch(iterator, device):
    """Stage upcoming host batches on `device`, two batches in flight.

    On a CUDA device each array goes to pinned host memory and is copied
    with `non_blocking` on a side stream, so the copy of the next batch
    overlaps the current step's compute; the consumer's stream waits on
    the copy's event before the batch is handed out (and the tensors are
    recorded on that stream, so the allocator keeps them until it is done
    with them). Elsewhere the batch is simply converted. A non-array entry
    (the eval loader's `num_real`) passes through as it is.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: to_tensor(v, device) for k, v in batch.items()}
        return
    copy_stream = torch.cuda.Stream(device)
    buf = collections.deque()

    def stage(batch):
        with torch.cuda.stream(copy_stream):
            out = {k: to_tensor(v, device, pin=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def hand_out(item):
        out, done = item
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(compute)
        return out

    for batch in iterator:
        buf.append(stage(batch))
        if len(buf) >= 2:
            yield hand_out(buf.popleft())
    while buf:
        yield hand_out(buf.popleft())


def to_tensor(v, device, pin: bool = False):
    """A numpy array -> a tensor on `device` (through pinned memory and a
    non-blocking copy with `pin`); anything else as it is."""
    if not isinstance(v, np.ndarray):
        return v
    t = torch.from_numpy(np.ascontiguousarray(v))
    if pin:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def epoch_batch_indices(
    n: int, batch_size: int, dg: bool, rng: np.random.RandomState
) -> list[np.ndarray]:
    """Shuffled batch index lists; each batch duplicated in dg mode."""
    idx = rng.permutation(n)
    num_batches = n // batch_size
    out = []
    for i in range(num_batches):
        batch = idx[i * batch_size : (i + 1) * batch_size]
        out.append(batch)
        if dg:
            out.append(batch.copy())
    return out


class TrainLoader:
    """Iterates fixed-shape train batches; reshuffles every epoch
    (the reference reloads its dataloader every epoch for the same effect,
    train_driving_dg.py:163)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        dg: bool,
        seed: int = 42,
        num_workers: int = 8,
        max_gt: int = T.MAX_GT,
        resample_replay: bool = False,
        rows: Optional[tuple] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = rows
        # reference-exact replay: the reference re-runs __getitem__ for the
        # dg duplicate batch, RE-SAMPLING the random flip (DGcommon.py:139-151
        # guarantees same images, not same pixels). Default (False) replays
        # identical pixels -- the stricter behaviour; --reference_quirks
        # flips this on for parity runs.
        self.resample_replay = resample_replay
        self.dg = dg
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self.max_gt = max_gt

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.batch_size
        return n * 2 if self.dg else n

    def _load_one(self, idx: int, aug_seed: int):
        img, boxes, labels, domain = self.dataset[int(idx)]
        return T.train_example(
            img, boxes, labels, domain, np.random.RandomState(aug_seed),
            self.max_gt)

    def epoch(self) -> Iterator[dict]:
        batches = epoch_batch_indices(
            len(self.dataset), self.batch_size, self.dg, self.rng
        )
        # dg mode: augmentation seeds key on the batch *pair* index so the
        # mode-0 and mode-k passes see IDENTICAL pixels (the reference
        # re-runs __getitem__ for the duplicate, re-sampling the flip;
        # resample_replay reproduces that).
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = Queue()

            def submit(bi, batch):
                pair = bi // 2 if (self.dg and not self.resample_replay) \
                    else bi
                seeds = [int(self.rng_epoch_base + pair * 131071 + j)
                         for j in range(len(batch))]
                lo, hi = self.rows or (0, len(batch))
                pending.put([pool.submit(self._load_one, idx, s)
                             for idx, s in zip(batch[lo:hi], seeds[lo:hi])])

            self.rng_epoch_base = int(self.rng.randint(0, 2**31 - 1))
            prefetch = 3
            buffered = 0
            for bi, batch in enumerate(batches):
                submit(bi, batch)
                buffered += 1
                if buffered > prefetch:
                    futures = pending.get()
                    yield T.stack_examples([f.result() for f in futures])
                    buffered -= 1
            while buffered:
                futures = pending.get()
                yield T.stack_examples([f.result() for f in futures])
                buffered -= 1


class EvalLoader:
    """Sequential fixed-shape eval batches (reference uses batch_size=1,
    train_driving_dg.py:146-147)."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        resize_to_train_size: bool = True,
        num_workers: int = 8,
        max_gt: int = T.MAX_GT,
        pad_to_batches: Optional[int] = None,
        rows: Optional[tuple] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = rows
        self.resize = resize_to_train_size
        self.num_workers = num_workers
        self.max_gt = max_gt
        # a multi-process run needs every process to run the same number
        # of batches; a process whose shard rounds to fewer pads with
        # all-dummy batches (num_real=0, masked from the metric)
        self.pad_to_batches = pad_to_batches

    def __len__(self):
        n = (len(self.dataset) + self.batch_size - 1) // self.batch_size
        if self.pad_to_batches is not None:
            n = max(n, self.pad_to_batches)
        return n

    def _load_one(self, idx: int):
        img, boxes, labels, domain = self.dataset[int(idx)]
        return T.eval_example(img, boxes, labels, domain, self.resize,
                              self.max_gt)

    def __iter__(self) -> Iterator[dict]:
        # bounded in-flight window: decoded canvases are ~MBs each, so
        # submitting the whole dataset up front would accumulate unbounded
        # host memory whenever eval is slower than decode
        n, b = len(self.dataset), self.batch_size
        start, stop = self.rows or (0, b)
        window = max(2 * self.num_workers, 4 * b)

        def block(k):
            """Batch k's dataset indices in this loader's rows, the tail
            batch padded by repeating its last image, and the rows' count
            of real images where the batch is the tail (else None)."""
            first = k * b
            idx = [min(first + j, n - 1) for j in range(start, stop)]
            real = min(max(n - first - start, 0), stop - start)
            return idx, (real if n - first < b else None)

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            in_flight = 0
            next_k = 0

            def fill():
                nonlocal in_flight, next_k
                while next_k * b < n and (not pending or in_flight < window):
                    idx, real = block(next_k)
                    futures = {i: pool.submit(self._load_one, i)
                               for i in dict.fromkeys(idx)}
                    pending.append((futures, idx, real))
                    in_flight += len(futures)
                    next_k += 1

            fill()
            emitted = 0
            last = None
            while pending:
                futures, idx, real = pending.popleft()
                in_flight -= len(futures)
                examples = {i: f.result() for i, f in futures.items()}
                fill()
                # the caller masks a tail batch's padding via 'num_real'
                last = T.stack_examples([examples[i] for i in idx])
                if real is not None:
                    last["num_real"] = real
                yield last
                emitted += 1
            if self.pad_to_batches is not None and last is not None:
                while emitted < self.pad_to_batches:
                    dummy = dict(last)
                    dummy["num_real"] = 0
                    yield dummy
                    emitted += 1
