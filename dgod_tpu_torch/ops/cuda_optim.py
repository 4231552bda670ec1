"""Wrapper of kernel K9 in `csrc/multi_tensor_update.cu` (CUDA C++, built
by `_build.py`): the optimizer's masked SGD or Adam update of every active
leaf of one call, in one pass over each element and one launch for each
`k9_capacity()` leaves. Its plain twin, which the CPU runs, is
`train/optim.py::update_plain`; the kernel reproduces its rounding bit for
bit (the source says how).

Per call the wrapper gathers each leaf's pointers, element count, gradient
sizes and strides and bias corrections into a table (`tables`, a pure
function of the leaves) and hands it to the kernel by value in the
launch's parameters: nothing is copied to the card, nothing is cached
between calls, and nothing outlives the launch. p, m and v must be
contiguous float32 on the card; the gradient is float32 of p's shape with
any strides (up to 4-D when not contiguous), or None for a zero gradient.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from . import _build

launches = 0  # K9 launches since import

VEC = 1  # p, m, v and g 16-byte aligned and g contiguous: float4 loads
STRIDED = 2  # g read through its own sizes and strides
ALIGN = 16
MAX_NUMEL = 2 ** 31 - 1

_lib = {}


class Table(NamedTuple):
    """One launch's leaves, as `k9_multi_tensor_update` takes them."""
    start: np.ndarray  # int64 [n + 1]: each leaf's offset on the line
    ptrs: np.ndarray  # uint64 [n, 4]: p, m, v, g (0: none)
    numel: np.ndarray  # int32 [n]
    gsize: np.ndarray  # int32 [n, 3]: sizes of dims 1-3 of g as 4-D
    gstride: np.ndarray  # int32 [n, 4]: g's strides as 4-D, in elements
    rc: np.ndarray  # float32 [n, 2]: 1 / (1 - b1^c), 1 / (1 - b2^c)
    flags: np.ndarray  # uint8 [n]: VEC, STRIDED


def _kernel():
    if not _lib:
        lib = _build.load("multi_tensor_update")
        fn = lib.k9_multi_tensor_update
        fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.k9_capacity.restype = ctypes.c_int
        _lib.update(fn=fn, capacity=lib.k9_capacity())
    return _lib["fn"], _lib["capacity"]


def scalars(lr: float, config) -> np.ndarray:
    """lr, wd, b1, 1 - b1, b2, 1 - b2 and eps as ATen rounds a Python
    scalar that meets a float32 tensor: computed in double, then rounded
    to float32."""
    return np.array([lr, config.weight_decay, config.b1, 1 - config.b1,
                     config.b2, 1 - config.b2, config.eps], dtype=np.float32)


def _layout(g: torch.Tensor):
    """-> (flags bit, sizes of dims 1-3, strides) of gradient `g`."""
    if g.is_contiguous():
        return 0, (1, 1, 1), (0, 0, 0, 0)
    if g.dim() > 4:
        raise ValueError(f"K9: a strided gradient of {g.dim()} dims; the "
                         f"kernel reads at most 4")
    pad = 4 - g.dim()
    sizes = (1,) * pad + tuple(g.shape)
    return STRIDED, sizes[1:], (0,) * pad + tuple(g.stride())


def _row(leaf, config, adam: bool, device: int):
    """One leaf's row of a table, checked (`device`: the index its tensors
    must lie on, -1 for the CPU); None for an empty leaf. Its bias
    corrections stay in double here: ATen multiplies a float32 CUDA tensor
    divided by the Python float 1 - b**c by that float's reciprocal taken
    in double, then rounded to float32 (read on the H100 with torch 2.11;
    neither a float32 division nor the float32 reciprocal of the rounded
    float gives the same bits), and `_table` rounds the column so."""
    p, g, m, v, count = leaf
    held = (p, m, v) if adam else (p,)
    for t in held:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.shape != p.shape or t.get_device() != device:
            raise ValueError(f"K9: p, m and v must be contiguous float32 "
                             f"of one shape on one device, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()} on "
                             f"{t.device}")
    if g is not None and (g.dtype != torch.float32 or g.shape != p.shape
                          or g.get_device() != device):
        raise ValueError(f"K9: a float32 gradient of {tuple(p.shape)} on "
                         f"p's device is needed, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    n = p.numel()
    if n == 0:
        return None
    if n > MAX_NUMEL:
        raise ValueError(f"K9: a leaf of {n} elements; at most {MAX_NUMEL}")
    ptrs = [t.data_ptr() for t in held] + [0] * (3 - len(held))
    if g is None:
        ptrs.append(0)
        flags, gsize, gstride = 0, (1, 1, 1), (0, 0, 0, 0)
    else:
        ptrs.append(g.data_ptr())
        flags, gsize, gstride = _layout(g)
    if flags == 0 and (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % ALIGN == 0:
        flags = VEC
    rc = (1.0 / (1 - config.b1 ** count), 1.0 / (1 - config.b2 ** count)) \
        if adam else (0.0, 0.0)
    return ptrs, n, gsize, gstride, rc, flags


def _table(rows) -> Table:
    ptrs, numel, gsize, gstride, rc, flags = zip(*rows)
    numel = np.array(numel, dtype=np.int32)
    start = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum((numel.astype(np.int64) + 3) // 4 * 4, out=start[1:])
    return Table(start, np.array(ptrs, dtype=np.uint64), numel,
                 np.array(gsize, dtype=np.int32),
                 np.array(gstride, dtype=np.int32),
                 np.array(rc, dtype=np.float32),
                 np.array(flags, dtype=np.uint8))


def tables(leaves: Sequence, config, capacity: int) -> List[Table]:
    """The launches of one update of `leaves` (train/optim.py::Leaf, each
    Adam count already advanced, every tensor on the first p's device),
    `capacity` leaves to a launch, in order; empty leaves are left out
    (nothing to do)."""
    adam = config.kind != "sgd"
    device = leaves[0].p.get_device() if leaves else -1
    rows = [r for r in (_row(leaf, config, adam, device) for leaf in leaves)
            if r is not None]
    return [_table(rows[i:i + capacity])
            for i in range(0, len(rows), capacity)]


def multi_tensor_update(leaves: Sequence, lr: float, config) -> None:
    """K9: one in-place step of `leaves` (all on one CUDA device), as
    `train/optim.py::update_plain` takes it."""
    global launches
    if not leaves:
        return
    dev = leaves[0].p.device
    if dev.type != "cuda":
        raise ValueError(f"K9 runs on a CUDA device, got {dev}")
    fn, capacity = _kernel()
    s = scalars(lr, config)
    stream = torch.cuda.current_stream(dev).cuda_stream
    adam = int(config.kind != "sgd")
    for t in tables(leaves, config, capacity):
        rc = fn(adam, len(t.numel), t.start.ctypes.data, t.ptrs.ctypes.data,
                t.numel.ctypes.data, t.gsize.ctypes.data,
                t.gstride.ctypes.data, t.rc.ctypes.data, t.flags.ctypes.data,
                s.ctypes.data, stream)
        _build.check_launch(rc, "k9_multi_tensor_update")
        launches += 1
