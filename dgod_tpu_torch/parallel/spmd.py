"""Data-parallel train steps with one fused gradient all-reduce per step
half (port of dgod_tpu/parallel/spmd.py).

Every rank holds the full replicated parameters and optimizer state (or,
with a model axis > 1, its slices of the split layers) and runs the port's
own step half (`train/steps.py::_half`) on its row block of the batch.
Between the backward and the update, `reduce_active_grads` packs the
mode's active gradients and the loss scalars into ONE contiguous float32
buffer and makes ONE all-reduce of it over the data group, so every rank
applies the identical update.

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

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..train.optim import OptConfig
from ..train.steps import _half, build_active_mask, pair_metrics
from ..utils.logging import span
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


def _reducer(active, mesh: Mesh, average: bool):
    def reduce(grads, metrics, params):
        return reduce_active_grads(grads, active, metrics, mesh.data_group,
                                   like=params, average=average)

    return reduce


def _sum_over_data(mesh: Mesh):
    """A count of this rank's rows -> the count over the data group."""
    def batch_sum(t: torch.Tensor) -> torch.Tensor:
        if dist.is_initialized():
            dist.all_reduce(t, group=mesh.data_group)
        return t

    return batch_sum


def _global_batch(mesh: Mesh) -> bool:
    return mesh.model > 1


def make_spmd_train_step(model, mode: int, reg_weights: Sequence[float],
                         opt_config: OptConfig, base_lr: float, mesh: Mesh):
    """-> step(opt_state, batch, draws, lr_scale=1.0) -> (opt_state,
    metrics) on this rank's rows, metrics reduced over the data group."""
    active = build_active_mask(model.param_group_labels(), mode)
    reg_weights = tuple(float(w) for w in reg_weights)
    glob = _global_batch(mesh)
    reduce = _reducer(active, mesh, average=not (glob and mode == 0))

    def step(opt_state, batch, draws, lr_scale=1.0):
        targets = model.pair_targets(batch, _sum_over_data(mesh)) \
            if glob else None
        return _half(model, opt_state, batch, draws, base_lr * lr_scale,
                     mode, active, reg_weights, opt_config, targets, reduce)

    return step


def make_spmd_pair_step(model, mode_k: int, reg_weights: Sequence[float],
                        opt_config: OptConfig, base_lr: float, mesh: Mesh):
    """The fused DG pair (mode 0, then mode k on the same batch; the
    single-device one is train/steps.py::make_pair_step) with one fused
    all-reduce per half.

    -> step(opt_state, batch, draws0, draws1, lr_scale=1.0) -> (opt_state,
    metrics)."""
    labels = model.param_group_labels()
    active_by_mode = {m: build_active_mask(labels, m) for m in (0, mode_k)}
    reg_weights = tuple(float(w) for w in reg_weights)
    glob = _global_batch(mesh)
    reduce = {m: _reducer(active_by_mode[m], mesh,
                          average=not (glob and m == 0))
              for m in (0, mode_k)}

    def step(opt_state, batch, draws0, draws1, lr_scale=1.0):
        lr = base_lr * lr_scale
        with span("dgod.pair"):
            with span("dgod.targets"):
                targets = model.pair_targets(
                    batch, _sum_over_data(mesh) if glob else None)
            opt_state, m0 = _half(model, opt_state, batch, draws0, lr, 0,
                                  active_by_mode[0], reg_weights, opt_config,
                                  targets, reduce[0])
            opt_state, mk = _half(model, opt_state, batch, draws1, lr,
                                  mode_k, active_by_mode[mode_k], reg_weights,
                                  opt_config, targets, reduce[mode_k])
        return opt_state, pair_metrics(m0, mk, mode_k)

    return step


def make_draws(model, mesh: Mesh, rows: int, num_gt: int,
               generator: torch.Generator, with_rpn: bool = True):
    """The sampling priorities of this rank's `rows` rows (None for FCOS,
    which draws nothing). Model axis 1: drawn for the local rows, the same
    on every rank. Model axis > 1: drawn for all `rows * data` rows of the
    global batch, and this rank's block kept."""
    if not _global_batch(mesh):
        return model.make_draws(rows, num_gt, generator, with_rpn=with_rpn)
    draws = model.make_draws(rows * mesh.data, num_gt, generator,
                             with_rpn=with_rpn)
    if draws is None:
        return None
    block = slice(mesh.d * rows, (mesh.d + 1) * rows)
    return type(draws)(*(None if t is None else t[block].contiguous()
                         for t in draws))
