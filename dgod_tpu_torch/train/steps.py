"""Train / eval steps, one per DG mode (port of dgod_tpu/train/steps.py).

A step mutates the model's parameters in place and returns the optimizer
state and the metrics (detached tensors: reading them is the caller's
choice, and the only host sync a step asks for is inside NMS).

Per mode, only the groups in MODE_ACTIVE_GROUPS take part:
`stop_inactive_grads` turns `requires_grad` off for every other parameter
(so autograd computes no gradient for it, the frozen backward included) and
`apply_updates` touches only the active ones. `ModeScheduler` reproduces
the reference's mode/sub-mode machine: in 'dg' the steps over replayed
batches run 0,1,0,2,0,3,0,4; the fused pair step runs mode 0 then mode k
on the same batch, and computes once what both halves take from the batch
alone (`model.pair_targets`: FCOS's matcher codes, one K4 launch per pair).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..parallel import spmd
from ..utils.logging import span
from .eval_graphs import EvalGraphs
from .optim import OptConfig, apply_updates

MODE_ACTIVE_GROUPS = {
    0: ("detector",),
    1: ("detector", "image_da", "ins_da"),
    2: ("ins_cls",),
    3: ("detector", "ins_cls_prime"),
    4: ("detector",),
}
# the profiler's name of each mode's step half
HALF_SPANS = tuple(f"dgod.half.m{m}" for m in range(5))


class ModeScheduler:
    """Host-side replica of the reference mode/sub_mode machine."""

    def __init__(self, dg: bool):
        self.dg = dg
        self._cycle = (0, 1, 0, 2, 0, 3, 0, 4)
        self._i = 0

    def next_mode(self) -> int:
        if not self.dg:
            return 0
        mode = self._cycle[self._i]
        self._i = (self._i + 1) % len(self._cycle)
        return mode

    def reset(self):
        self._i = 0


def build_active_mask(labels: Dict[str, str], mode: int) -> Dict[str, bool]:
    active_groups = MODE_ACTIVE_GROUPS[mode]
    return {n: lbl in active_groups for n, lbl in labels.items()}


class ModeSet(NamedTuple):
    """One mode's participation, decided when its step is built: the mask
    that `apply_updates` and the reducer take, the active names and
    parameters in `named_parameters` order, every parameter by name, each
    parameter's `requires_grad` under the mode, and the data group's
    reduction (None on one card). Built after the model's parameters are
    final: `shard_model` rebinds the split ones."""
    mode: int
    active: Dict[str, bool]
    names: Tuple[str, ...]
    leaves: Tuple[torch.nn.Parameter, ...]
    params: Dict[str, torch.nn.Parameter]
    requires: Tuple[Tuple[torch.nn.Parameter, bool], ...]
    reduce: Optional[Callable]


def mode_set(model, mode: int, mesh=None) -> ModeSet:
    """`mode`'s ModeSet of `model`; with `mesh`, its reduction over the
    data group (parallel/spmd.py::mode_reducer)."""
    active = build_active_mask(model.param_group_labels(), mode)
    params = dict(model.named_parameters())
    names = tuple(n for n, a in active.items() if a)
    reduce = (None if mesh is None
              else spmd.mode_reducer(mesh, mode, active, params))
    return ModeSet(mode, active, names, tuple(params[n] for n in names),
                   params, tuple((p, active[n]) for n, p in params.items()),
                   reduce)


def stop_inactive_grads(mset: ModeSet):
    """requires_grad only on the mode's active parameters (the port of
    `stop_gradient` on the inactive leaves). Gradients still flow through
    frozen layers' activations where an active parameter lies below them;
    nothing active lies below layer2, so that backward is never built."""
    for p, on in mset.requires:
        p.requires_grad_(on)


def _half(model, opt_state, batch, draws, lr, mset: ModeSet, reg_weights,
          opt_config, targets=None):
    """One step half: the mode's loss, its gradients, the update; on a
    mesh the data group's all-reduce runs between the backward and the
    update."""
    with span(HALF_SPANS[mset.mode]):
        stop_inactive_grads(mset)
        with span("dgod.forward"):
            total, metrics = model.loss_for_mode(batch, draws, mset.mode,
                                                 reg_weights,
                                                 **(targets or {}))
        with span("dgod.backward"):
            grads = dict(zip(mset.names, torch.autograd.grad(
                total, mset.leaves, allow_unused=True)))
        metrics = dict(metrics)
        metrics["loss"] = total.detach()
        if mset.reduce is not None:
            grads, metrics = mset.reduce(grads, metrics)
        opt_state = apply_updates(mset.params, grads, opt_state,
                                  mset.active, lr, opt_config)
    return opt_state, metrics


def pair_metrics(m0, mk, mode_k: int):
    """The metrics of a fused pair: both halves' under 'm0/' and
    'm{k}/', with 'loss' mode k's total and 'loss0' mode 0's."""
    metrics = {f"m0/{k}": v for k, v in m0.items()}
    metrics.update({f"m{mode_k}/{k}": v for k, v in mk.items()})
    metrics["loss"] = mk["loss"]
    metrics["loss0"] = m0["loss"]
    return metrics


def make_train_step(model, mode: int, reg_weights: Sequence[float],
                    opt_config: OptConfig, base_lr: float, mesh=None):
    """-> step(opt_state, batch, draws, lr_scale=1.0) -> (opt_state,
    metrics); updates the model's parameters in place. With `mesh`
    (parallel/mesh.py) the step runs on this rank's rows and its gradients
    and metrics are reduced over the data group."""
    mset = mode_set(model, mode, mesh)
    batch_sum = spmd.batch_sum(mesh)
    reg_weights = tuple(float(w) for w in reg_weights)

    def step(opt_state, batch, draws, lr_scale=1.0):
        targets = (None if batch_sum is None
                   else model.pair_targets(batch, batch_sum))
        return _half(model, opt_state, batch, draws, base_lr * lr_scale,
                     mset, reg_weights, opt_config, targets)

    return step


def make_pair_step(model, mode_k: int, reg_weights: Sequence[float],
                   opt_config: OptConfig, base_lr: float, mesh=None):
    """Fused DG pair: the mode-0 update, then the mode-k update on the same
    batch (the mode-k pass sees the mode-0-updated parameters). What both
    halves take from the batch alone is computed once, before them
    (`model.pair_targets`); it reads no parameter, so either half gets what
    it would compute itself. `mesh` as in `make_train_step`: one fused
    all-reduce per half.

    -> step(opt_state, batch, draws0, draws1, lr_scale=1.0) -> (opt_state,
    metrics) with the metrics of both halves."""
    m0, mk = (mode_set(model, m, mesh) for m in (0, mode_k))
    batch_sum = spmd.batch_sum(mesh)
    reg_weights = tuple(float(w) for w in reg_weights)

    def step(opt_state, batch, draws0, draws1, lr_scale=1.0):
        lr = base_lr * lr_scale
        with span("dgod.pair"):
            with span("dgod.targets"):
                targets = model.pair_targets(batch, batch_sum)
            opt_state, metrics0 = _half(model, opt_state, batch, draws0, lr,
                                        m0, reg_weights, opt_config, targets)
            opt_state, metrics_k = _half(model, opt_state, batch, draws1, lr,
                                         mk, reg_weights, opt_config, targets)
        return opt_state, pair_metrics(metrics0, metrics_k, mode_k)

    return step


def make_eval_step(model):
    """-> step(batch) -> model.predict(batch) without autograd. On the card
    each input signature is captured once as a CUDA graph and replayed
    (train/eval_graphs.py); elsewhere, or where a capture fails, the
    predict runs eagerly."""
    graphs = EvalGraphs(model)

    @torch.no_grad()
    def step(batch):
        return graphs(batch)

    return step


def make_optimizer(model_name: str, backbone=None) -> tuple:
    """Reference hyperparameters: FRCNN SGD(2e-3, wd 5e-4), FCOS Adam(1e-4,
    wd 1e-4); `backbone`, the model's backbone module, where its
    `optimizer` (kind, lr, weight decay) is set, replaces the family's
    (ViTDet-B: Adam(1e-4, wd 1e-4))."""
    own = getattr(backbone, "optimizer", None)
    if own is not None:
        kind, lr, weight_decay = own
        return OptConfig(kind, weight_decay=weight_decay), lr
    if model_name == "FRCNN":
        return OptConfig("sgd", weight_decay=5e-4), 2e-3
    if model_name == "FCOS":
        return OptConfig("adam", weight_decay=1e-4), 1e-4
    raise ValueError(model_name)
