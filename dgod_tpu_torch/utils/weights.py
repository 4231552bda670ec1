"""Weights carried from the JAX model to the port.

`params_from_jax(tree)` takes the parameter tree of a JAX DGFRCNNModel or
DGFCOSModel as nested dicts of numpy arrays (e.g.
`jax.tree.map(np.asarray, params)`) and returns the port's `state_dict`:
the port's parameter names are the tree's paths joined with '.', with
`kernel` renamed `weight`.

- conv kernels: HWIO -> OIHW;
- dense kernels: [in, out] -> [out, in] (fc6 included: both models flatten
  the pooled RoI patch HWC, so it is a plain transpose);
- DomainBank kernels `bank/fc{i}/kernel` [D, in, out] keep their layout;
- FrozenBatchNorm `scale/bias/mean/var` become the port's buffers;
- GroupNorm `scale/bias` (the FCOS head) are the port's trainable
  parameters of the same names.

Every leaf is used; an unknown leaf raises. Loading a torchvision
checkpoint directly waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

TOP_LEVEL = ("detector", "image_da", "ins_da", "ins_cls", "ins_cls_prime")
BN_LEAVES = ("scale", "mean", "var")


def _walk(tree: Mapping, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _walk(val, path)
        else:
            yield path, val


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    unknown_top = set(tree) - set(TOP_LEVEL)
    if unknown_top:
        raise KeyError(f"params_from_jax: unknown top-level keys "
                       f"{sorted(unknown_top)}")
    out = {}
    for path, val in _walk(tree):
        arr = np.array(val, dtype=np.float32)  # a writable copy
        leaf = path[-1]
        name = ".".join(path[:-1])
        if leaf == "kernel":
            if arr.ndim == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # dense [in, out] -> [out, in]
                arr = arr.T
            elif arr.ndim == 3 and "bank" in path:  # [D, in, out] as is
                pass
            else:
                raise ValueError(f"params_from_jax: unexpected kernel shape "
                                 f"{arr.shape} at {'/'.join(path)}")
            key = f"{name}.weight"
        elif leaf == "bias" or leaf in BN_LEAVES:
            key = f"{name}.{leaf}"
        else:
            raise KeyError(f"params_from_jax: unknown leaf {'/'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy a JAX parameter tree into `model`; every key on both sides must
    match (strict)."""
    sd = params_from_jax(tree)
    model.load_state_dict(sd, strict=True)
