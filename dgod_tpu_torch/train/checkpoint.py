"""Single-file checkpoints, the port's `.ckpt` format (the semantics of
dgod_tpu/train/checkpoint.py::PickleStore).

A checkpoint holds the model's state_dict (parameters and FrozenBatchNorm
statistics), the optimizer state and a metadata dict, written with
`torch.save` to a temporary file and renamed over the path (atomic: a
reader never sees half a file), and read back with `weights_only=True`.
It is the port's own format: a JAX package `.ckpt` (flax bytes in a
pickle) is refused, not converted.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def tree_to(tree, device):
    """Every tensor of nested dicts moved to `device`; other leaves as
    they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree


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
        payload = {"params": tree_to(dict(params), "cpu"),
                   "opt_state": tree_to(opt_state, "cpu"),
                   "meta": dict(meta, step=int(step))}
        tmp = self.path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path)

    def load_latest(self) -> Optional[Tuple[Dict[str, torch.Tensor], Any,
                                            Dict[str, Any]]]:
        """-> (params, opt_state, meta) with tensors on the CPU, or None
        when there is no checkpoint."""
        if not self.exists():
            return None
        try:
            payload = torch.load(self.path, map_location="cpu",
                                 weights_only=True)
        except Exception as e:
            raise ValueError(
                f"{self.path} is not a dgod_tpu_torch checkpoint ({e}); a "
                "JAX package .ckpt cannot be loaded by the port (ROADMAP "
                "Queue A 14)") from e
        if not (isinstance(payload, dict)
                and {"params", "opt_state", "meta"} <= payload.keys()):
            raise ValueError(f"{self.path} is not a dgod_tpu_torch checkpoint")
        return payload["params"], payload["opt_state"], payload["meta"]

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""


def make_store(path: str) -> CheckpointStore:
    """A `.ckpt` path -> the single-file store. The JAX package takes any
    other path as an orbax directory; the port has no directory store yet."""
    if path.endswith(".ckpt"):
        return CheckpointStore(path)
    raise NotImplementedError(
        f"checkpoint path {path!r}: the port stores single '.ckpt' files "
        "only; directory (orbax) stores are ROADMAP Queue A 14")
