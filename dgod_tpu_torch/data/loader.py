"""Batch loaders with the DG twice-per-batch sampler, threaded decode, and
the copy of batches to the card (the port's own copy of
dgod_tpu/data/loader.py).

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
import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator, Optional

import numpy as np

from . import transforms as T

# torch is imported inside the functions that use it: ProcessTrainLoader's
# child process imports this module, and an import of torch (its CUDA
# libraries) costs it seconds of start-up for nothing

# serialises the os.environ window in ProcessTrainLoader._start (a spawned
# child inherits the parent's environment; Process has no env= parameter)
_SPAWN_ENV_LOCK = threading.Lock()
# how often a waiting parent looks whether its loader child is alive (s)
POLL_S = 5.0


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
    import torch

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
    import torch

    t = torch.from_numpy(np.ascontiguousarray(v))
    if pin:
        # an array in page-locked memory already (ProcessTrainLoader's
        # pin_memory) is copied from where it is
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


def _slot_views(buf, spec):
    """One shared-memory slot's buffer as per-key numpy views: the single
    definition of the slot layout, used by both sides of the ring, the
    writer (`_loader_proc_main`) and the reader (`ProcessTrainLoader`)."""
    off, views = 0, {}
    for k, shape, dtype in spec:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        views[k] = np.ndarray(shape, dtype, buffer=buf[off:off + n])
        off += n
    return views


def _loader_proc_main(dataset, loader_kwargs, t_overrides, n_slots,
                      full_q, free_q):
    """The child process of ProcessTrainLoader: a TrainLoader (its thread
    pool and all) writing each fixed-shape batch into one of `n_slots`
    shared-memory slots. A failure (a bad file, an empty dataset) is
    reported through the queue, so the parent raises instead of waiting on
    a dead child."""
    from multiprocessing import shared_memory

    for k, v in t_overrides.items():
        setattr(T, k, v)
    shms, views = [], []  # views[slot][key] -> np.ndarray in that slot
    try:
        loader = TrainLoader(dataset, **loader_kwargs)
        if loader.steps_per_epoch() == 0:
            raise ValueError(
                f"empty loader: {len(dataset)} examples < batch_size "
                f"{loader_kwargs['batch_size']}")
        while True:
            for batch in loader.epoch():
                if not shms:
                    spec = [(k, v.shape, str(v.dtype))
                            for k, v in batch.items()]
                    nbytes = sum(int(np.prod(s)) * np.dtype(d).itemsize
                                 for _, s, d in spec)
                    for _ in range(n_slots):
                        shm = shared_memory.SharedMemory(
                            create=True, size=max(nbytes, 1))
                        shms.append(shm)
                        views.append(_slot_views(shm.buf, spec))
                    full_q.put(("spec", spec, [m.name for m in shms]))
                slot = free_q.get()
                if slot is None:
                    return
                for k, v in batch.items():
                    views[slot][k][...] = v
                full_q.put(("batch", slot))
    except (KeyboardInterrupt, BrokenPipeError, EOFError):
        pass
    except Exception as e:  # surface it in the parent, do not hang it
        full_q.put(("error", f"{type(e).__name__}: {e}"))
    finally:
        views.clear()
        for shm in shms:
            shm.close()
            shm.unlink()


class ProcessTrainLoader:
    """A TrainLoader run in a child process, its batches passed through
    shared memory (the port of dgod_tpu/data/loader.py's).

    The same iteration contract as TrainLoader: `epoch()` and
    `steps_per_epoch()`, a reshuffle every epoch, the dg duplicate batches,
    `resample_replay`, and a mesh rank's `rows=(start, stop)` block; the
    batches are TrainLoader's, bit for bit. The reference gets this
    isolation from its multiprocess DataLoader workers (DGcommon.py:151).

    Why a process: the training thread issues every kernel launch, and the
    loader threads' Python work (collation, the transforms' numpy glue)
    takes the GIL from it; in a child that work holds another
    interpreter's lock. The child is spawned with CUDA_VISIBLE_DEVICES=""
    so it never creates a CUDA context (~0.5 GB of the card each). With
    `pin_memory` the parent copies each slot straight into page-locked
    memory, from which `device_prefetch` copies to the card without a
    second host copy. A child that dies or reports an error raises
    RuntimeError in the parent within POLL_S seconds.
    """

    _T_OVERRIDE_KEYS = ("CANVAS", "TRAIN_SIZE", "MIN_SIZE", "MAX_SIZE",
                        "MIN_AREA", "MAX_GT")

    def __init__(self, dataset, batch_size: int, dg: bool, seed: int = 42,
                 num_workers: int = 8, max_gt: Optional[int] = None,
                 n_slots: int = 4, resample_replay: bool = False,
                 rows: Optional[tuple] = None, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self._kwargs = dict(
            batch_size=batch_size, dg=dg, seed=seed, num_workers=num_workers,
            max_gt=T.MAX_GT if max_gt is None else max_gt,
            resample_replay=resample_replay, rows=rows)
        self.n_slots = n_slots
        self.pin_memory = pin_memory
        self._proc = None
        self._shms: list = []
        self._views: list = []

    def _set_before_start(self, key, value):
        if self._proc is not None:
            raise RuntimeError(f"cannot change {key} after the loader "
                               "started")
        self._kwargs[key] = value

    # the harness turns dg off under fused pairs, and sets a mesh rank's
    # rows, before the first epoch: both must reach the child
    dg = property(lambda self: self._kwargs["dg"],
                  lambda self, v: self._set_before_start("dg", v))
    rows = property(lambda self: self._kwargs["rows"],
                    lambda self, v: self._set_before_start("rows", v))

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.batch_size
        return n * 2 if self.dg else n

    def _get_msg(self):
        """The child's next message; RuntimeError if it reported an error or
        died (polled every POLL_S seconds, never a wait forever)."""
        while True:
            try:
                msg = self._full_q.get(timeout=POLL_S)
            except queue_mod.Empty:
                if not self._proc.is_alive():
                    raise RuntimeError(
                        "loader child process died (exitcode "
                        f"{self._proc.exitcode})") from None
                continue
            if msg[0] == "error":
                raise RuntimeError(f"loader child process failed: {msg[1]}")
            return msg

    def _start(self):
        import multiprocessing as mp
        from multiprocessing import shared_memory

        ctx = mp.get_context("spawn")
        self._full_q = ctx.Queue()
        self._free_q = ctx.Queue()
        overrides = {k: getattr(T, k) for k in self._T_OVERRIDE_KEYS}
        self._proc = ctx.Process(
            target=_loader_proc_main,
            args=(self.dataset, self._kwargs, overrides, self.n_slots,
                  self._full_q, self._free_q),
            daemon=True)
        # the child sees no card, so nothing in it can create a CUDA
        # context; the environment is the parent's for a few ms, under a
        # lock that serialises concurrent starts
        with _SPAWN_ENV_LOCK:
            saved = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                self._proc.start()
            finally:
                if saved is None:
                    del os.environ["CUDA_VISIBLE_DEVICES"]
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = saved
        kind, spec, names = self._get_msg()
        if kind != "spec":
            raise RuntimeError(f"loader child process sent {kind!r} first")
        self._spec = spec
        for name in names:
            shm = shared_memory.SharedMemory(name=name)
            self._shms.append(shm)
            self._views.append(_slot_views(shm.buf, spec))
        for slot in range(self.n_slots):
            self._free_q.put(slot)

    def _copy_out(self, views) -> dict:
        """A slot's batch, copied so the slot can go back to the child
        before the (asynchronous) copy to the card ends."""
        if not self.pin_memory:
            return {k: v.copy() for k, v in views.items()}
        import torch

        out = {}
        for k, v in views.items():
            dtype = torch.from_numpy(v[:0]).dtype
            out[k] = torch.empty(v.shape, dtype=dtype,
                                 pin_memory=True).numpy()
            np.copyto(out[k], v)
        return out

    def epoch(self) -> Iterator[dict]:
        if self._proc is None:
            self._start()
        for _ in range(self.steps_per_epoch()):
            kind, slot = self._get_msg()
            if kind != "batch":
                raise RuntimeError(f"loader child process sent {kind!r}")
            out = self._copy_out(self._views[slot])
            self._free_q.put(slot)
            yield out

    def close(self):
        """Stop the child (asking first, then terminating it) and release
        the shared memory; the loader can start again after."""
        if self._proc is not None:
            try:
                self._free_q.put(None)
            except (ValueError, OSError):  # the queue is closed already
                pass
            self._proc.join(timeout=2)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=5)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=5)
            for q in (self._full_q, self._free_q):
                q.cancel_join_thread()
                q.close()
            self._proc = None
        self._views = []
        for shm in self._shms:
            shm.close()
            try:  # a child that was terminated did not unlink its slots
                shm.unlink()
            except FileNotFoundError:
                pass
        self._shms = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


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
