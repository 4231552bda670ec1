"""Checkpoint stores (the port of dgod_tpu/train/checkpoint.py).

Two stores behind one interface (exists / save / load_latest / wait), as
in the JAX package; `make_store` picks by the path:

- `CheckpointStore`, a path ending in `.ckpt`: one file, written
  synchronously with `torch.save` to a temporary name and renamed over the
  path (a reader never sees half a file), read back with
  `weights_only=True`. It also reads the JAX package's `.ckpt` (a pickle
  of flax msgpack bytes, dgod_tpu/train/checkpoint.py::PickleStore):
  `params` and Adam's `mu` and `nu` through `utils/weights.py::
  params_from_jax`, each `count` leaf an int, `meta` as it is. The next
  save at that path writes the port's format.
- `DirectoryStore`, any other path: the port's counterpart of the JAX
  package's orbax store, asynchronous, keeping only the newest step, in a
  layout of its own: `<dir>/<step>/state.pt` and `meta.json`.

A checkpoint holds the model's state_dict (parameters and FrozenBatchNorm
statistics), the optimizer state and a metadata dict.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils import weights as weights_lib
from . import flax_msgpack


def tree_to(tree, device):
    """Every tensor of nested dicts moved to `device`; other leaves as
    they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree


def _payload(step: int, params, opt_state, meta) -> Dict[str, Any]:
    return {"params": dict(params), "opt_state": opt_state,
            "meta": dict(meta, step=int(step))}


def _checked(payload, path: str):
    if not (isinstance(payload, dict)
            and {"params", "opt_state", "meta"} <= payload.keys()):
        raise ValueError(f"{path} is not a dgod_tpu_torch checkpoint")
    return payload["params"], payload["opt_state"], payload["meta"]


class _JaxPickle(pickle.Unpickler):
    """Unpickles the JAX package's `.ckpt` dict: bytes, numbers, strings,
    and numpy scalars in `meta`; any other class is refused."""

    _ALLOWED = {("numpy._core.multiarray", "scalar"),
                ("numpy.core.multiarray", "scalar"), ("numpy", "dtype")}

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed")


def _plain(v):
    """A numpy scalar of the JAX package's meta -> a Python number."""
    return v.item() if hasattr(v, "item") else v


def load_jax_ckpt(path: str):
    """The JAX package's `.ckpt` -> (params, opt_state, meta) in the
    port's layout, tensors on the CPU; ValueError if the file is not one."""
    try:
        with open(path, "rb") as f:
            payload = _JaxPickle(f).load()
    except (pickle.UnpicklingError, EOFError, ValueError) as e:
        raise ValueError(f"{path} is not a dgod_tpu_torch checkpoint ({e})"
                         ) from e
    if not (isinstance(payload, dict)
            and isinstance(payload.get("params"), bytes)
            and isinstance(payload.get("opt_state"), bytes)):
        raise ValueError(f"{path} is not a dgod_tpu_torch checkpoint")
    params = weights_lib.params_from_jax(
        flax_msgpack.msgpack_restore(payload["params"]))
    # the port keeps FrozenBatchNorm's four tensors as buffers, which the
    # optimizer does not hold; JAX holds them as (masked) parameters
    frozen = {k.rsplit(".", 1)[0] for k in params if k.endswith(".var")}
    names = [k for k in params if k.rsplit(".", 1)[0] not in frozen]
    opt_state = weights_lib.opt_state_from_jax(
        flax_msgpack.msgpack_restore(payload["opt_state"]), names)
    meta = {k: _plain(v) for k, v in payload.get("meta", {}).items()}
    return params, opt_state, meta


class CheckpointStore:
    """One `.ckpt` file: exists / save / load_latest / wait."""

    def __init__(self, path: str):
        self.path = path

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, step: int, params: Dict[str, torch.Tensor], opt_state,
             meta: Dict[str, Any]) -> None:
        """params: a state_dict; opt_state: nested dicts of tensors and
        numbers; meta: numbers and strings. Tensors are saved from the CPU."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        payload = _payload(step, tree_to(dict(params), "cpu"),
                           tree_to(opt_state, "cpu"), meta)
        tmp = self.path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path)

    def load_latest(self) -> Optional[Tuple[Dict[str, torch.Tensor], Any,
                                            Dict[str, Any]]]:
        """-> (params, opt_state, meta) with tensors on the CPU, or None
        when there is no checkpoint."""
        if not self.exists():
            return None
        with open(self.path, "rb") as f:
            zipped = f.read(2) == b"PK"  # torch.save's zip archive
        if not zipped:
            return load_jax_ckpt(self.path)
        try:
            payload = torch.load(self.path, map_location="cpu",
                                 weights_only=True)
        except Exception as e:
            raise ValueError(f"{self.path} is not a dgod_tpu_torch "
                             f"checkpoint ({e})") from e
        return _checked(payload, self.path)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""


STATE_FILE, META_FILE = "state.pt", "meta.json"


def _snapshot(tree, stream):
    """Host copies of every tensor of nested dicts: a card's tensors into
    pinned memory, copied on `stream`; the CPU's cloned."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "cuda":
            return tree.detach().clone()
        host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(tree, non_blocking=True)
        tree.record_stream(stream)  # kept until the copy has run
        return host
    if isinstance(tree, dict):
        return {k: _snapshot(v, stream) for k, v in tree.items()}
    return tree


def _has_cuda(tree) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.device.type == "cuda" else None
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _has_cuda(v)
            if dev is not None:
                return dev
    return None


class DirectoryStore:
    """Asynchronous checkpoints in a directory, only the newest kept: the
    port's counterpart of dgod_tpu/train/checkpoint.py::OrbaxStore.

    `save` snapshots every tensor into host memory (a card's on a side
    stream into pinned memory; the card's current stream then waits for
    that copy, so a later in-place optimizer step cannot reach what is
    written) and returns. One writer thread waits for the copy, writes
    `<dir>/<step>/state.pt` and `meta.json` into a temporary directory,
    renames it to `<dir>/<step>`, then removes the older steps. `exists`
    means a finished step is there; `wait` joins the writer, and an error
    in the writer is raised at the next `save` or `wait`. On a mesh rank 0
    alone saves the gathered tensors (train/harness.py), where orbax has
    each process write its own shards.

    The JAX package's orbax directories need orbax and tensorstore; a
    directory in that layout raises.
    """

    def __init__(self, directory: str):
        self.dir = os.path.abspath(directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _steps(self):
        """The finished steps, oldest first."""
        if not os.path.isdir(self.dir):
            return []
        steps = []
        for name in os.listdir(self.dir):
            sub = os.path.join(self.dir, name)
            if not (name.isdigit() and os.path.isdir(sub)):
                continue
            files = set(os.listdir(sub))
            if {STATE_FILE, META_FILE} <= files:
                steps.append(int(name))
            elif "_CHECKPOINT_METADATA" in files or "state" in files:
                raise ValueError(
                    f"{sub} is an orbax checkpoint of the JAX package; the "
                    "port reads its own directory layout (<step>/"
                    f"{STATE_FILE}, {META_FILE}); orbax's needs orbax and "
                    "tensorstore")
        return sorted(steps)

    def exists(self) -> bool:
        return bool(self._steps())

    def save(self, step: int, params: Dict[str, torch.Tensor], opt_state,
             meta: Dict[str, Any]) -> None:
        self.wait()  # one write at a time; raises the last one's error
        payload = _payload(step, params, opt_state, meta)
        dev = _has_cuda(payload)
        done = None
        if dev is None:
            host = _snapshot(payload, None)
        else:
            compute = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(compute)  # the values as of this call
            host = _snapshot(payload, side)
            done = torch.cuda.Event()
            done.record(side)
            compute.wait_event(done)  # later updates wait for the copy
        self._thread = threading.Thread(
            target=self._write, args=(int(step), host, done),
            name="DirectoryStore.write")
        self._thread.start()

    def _write(self, step: int, host, done) -> None:
        try:
            if done is not None:
                done.synchronize()
            os.makedirs(self.dir, exist_ok=True)
            tmp = os.path.join(self.dir, f".{step}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({"params": host["params"],
                        "opt_state": host["opt_state"]},
                       os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(host["meta"], f, default=_plain)
            final = os.path.join(self.dir, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self._steps():
                if old != step:
                    shutil.rmtree(os.path.join(self.dir, str(old)))
        except Exception as e:  # raised in the caller's thread
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"checkpoint write to {self.dir} failed"
                               ) from error

    def load_latest(self) -> Optional[Tuple[Dict[str, torch.Tensor], Any,
                                            Dict[str, Any]]]:
        """-> (params, opt_state, meta) of the newest finished step, tensors
        on the CPU, or None when there is none."""
        self.wait()
        steps = self._steps()
        if not steps:
            return None
        sub = os.path.join(self.dir, str(steps[-1]))
        state = torch.load(os.path.join(sub, STATE_FILE), map_location="cpu",
                           weights_only=True)
        with open(os.path.join(sub, META_FILE)) as f:
            meta = json.load(f)
        return state["params"], state["opt_state"], meta


def make_store(path: str):
    """A `.ckpt` path -> the single-file store (the reference's one-file
    workflow, train_driving_dg.py:154-155); any other -> a directory."""
    if path.endswith(".ckpt"):
        return CheckpointStore(path)
    return DirectoryStore(path)
