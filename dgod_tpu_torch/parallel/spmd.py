"""Data parallelism of the train steps: one fused gradient all-reduce per
step half, and the draws and counts of a global batch (port of
dgod_tpu/parallel/spmd.py).

Every rank holds the full replicated parameters and optimizer state (or,
with a model axis > 1, its slices of the split layers) and runs the port's
own steps (`train/steps.py`, built with `mesh=`) on its row block of the
batch. Between the backward and the update, `reduce_active_grads` packs
the mode's active gradients and the loss scalars into ONE contiguous
float32 buffer and makes ONE all-reduce of it over the data group, so
every rank applies the identical update.

Two semantics, as the JAX package has them:

- model axis 1 (the JAX package's shard_map steps): each rank's losses
  are normalised over its own rows and the reduction is a mean; every rank
  draws its sampling priorities for its own rows from the same generator
  state (shard_map's replicated key);
- model axis > 1 (the JAX package's GSPMD path, which runs the program of
  the global batch): the steps compute the unsharded step's losses. Mode
  0's losses are sums over the batch's images (Faster R-CNN's per-image
  losses; FCOS's, over the batch's foreground count, which is summed over
  the data group first), so their reduction is a sum; modes 1-4 are means
  over equal row blocks, so theirs is a mean. Priorities are drawn for the
  global rows and each rank keeps its block (`make_draws`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


def reduce_active_grads(grads: Dict[str, Optional[torch.Tensor]],
                        active: Dict[str, bool], scalars=None, group=None,
                        like: Dict[str, torch.Tensor] = None,
                        average: bool = True):
    """ONE all-reduce over `group` of the mode's ACTIVE gradients, then a
    divide by the group's size (`average`).

    The buffer's layout follows the static mask alone: an active gradient
    that autograd left None (a parameter the loss does not reach) goes in
    as zeros of `like[name]`'s shape, so every rank packs the same
    entries. Inactive entries are not sent (mode 2 would otherwise ship
    the whole frozen ResNet-50-FPN) and pass through untouched. `scalars`
    (a dict of 0-dim tensors, the step's metrics) ride the same buffer.
    -> grads, or (grads, scalars) when scalars are given. Without a process
    group nothing is sent."""
    names = [n for n, a in active.items() if a]
    parts = []
    for n in names:
        g = grads.get(n)
        parts.append(torch.zeros_like(like[n]) if g is None else g)
    s_names = list(scalars or {})
    flat = [p.reshape(-1).float() for p in parts]
    flat += [scalars[k].reshape(1).float() for k in s_names]
    buf = torch.cat(flat)
    if dist.is_initialized():
        dist.all_reduce(buf, group=group)
        if average:
            # a device tensor: IEEE division, as the kernels divide
            buf.div_(torch.full((), float(dist.get_world_size(group)),
                                device=buf.device))
    out = dict(grads)
    offset = 0
    for n, p in zip(names, parts):
        out[n] = buf[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
    if scalars is None:
        return out
    red = {k: buf[offset + i] for i, k in enumerate(s_names)}
    return out, red


def mode_reducer(mesh: Mesh, mode: int, active: Dict[str, bool],
                 like: Dict[str, torch.Tensor]):
    """-> reduce(grads, metrics) -> (grads, metrics): one mode's fused
    all-reduce over the data group, a sum for mode 0 under a model axis
    > 1 (its losses are sums over the global batch there) and a mean
    otherwise. `train/steps.py` runs it between a half's backward and its
    update."""
    average = not (_global_batch(mesh) and mode == 0)

    def reduce(grads, metrics):
        return reduce_active_grads(grads, active, metrics, mesh.data_group,
                                   like=like, average=average)

    return reduce


def batch_sum(mesh: Optional[Mesh]):
    """Under a model axis > 1, the function that turns a count of this
    rank's rows into the count over the data group (`model.pair_targets`'
    `batch_sum`); else None: each rank's losses are its own rows'."""
    if not _global_batch(mesh):
        return None

    def total(t: torch.Tensor) -> torch.Tensor:
        if dist.is_initialized():
            dist.all_reduce(t, group=mesh.data_group)
        return t

    return total


def _global_batch(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.model > 1


def make_draws(model, mesh: Optional[Mesh], rows: int, num_gt: int,
               generator: torch.Generator, with_rpn: bool = True):
    """The sampling priorities of this rank's `rows` rows (None for FCOS,
    which draws nothing). No mesh or model axis 1: drawn for the local
    rows, the same on every rank. Model axis > 1: drawn for all
    `rows * data` rows of the global batch, and this rank's block kept."""
    if not _global_batch(mesh):
        return model.make_draws(rows, num_gt, generator, with_rpn=with_rpn)
    draws = model.make_draws(rows * mesh.data, num_gt, generator,
                             with_rpn=with_rpn)
    if draws is None:
        return None
    block = slice(mesh.d * rows, (mesh.d + 1) * rows)
    return type(draws)(*(None if t is None else t[block].contiguous()
                         for t in draws))
