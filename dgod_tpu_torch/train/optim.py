"""Optimizers with per-mode participation masks, and the host-side
plateau LR scheduler and early stopping (port of dgod_tpu/train/optim.py).

Each mode updates only its active parameters. The update is written out by
hand rather than through `torch.optim`, because it must touch every active
parameter, including one the loss never reaches: such a parameter gets a
zero gradient and still takes weight decay, as the JAX masked update does
(torch.optim would skip it, its grad being None). Adam keeps a step count
per parameter, advanced only when the parameter is active.

- SGD: p <- p - lr * (g + wd * p)  (coupled L2, momentum 0)
- Adam: coupled L2 (g += wd * p), b1 0.9, b2 0.999, eps 1e-8, bias
  correction with the per-parameter step count.

On the card one kernel, K9 (ops/cuda_optim.py), updates every active leaf
of a call in one pass, bit for bit as `update_plain`, the loop of ATen
operations that the CPU runs.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from ..ops import cuda_optim
from ..utils.logging import span

# leaf updates since import: by K9 (ops/cuda_optim.py), by the plain loop
fused_leaves = 0
plain_leaves = 0


class OptConfig(NamedTuple):
    kind: str  # 'sgd' | 'adam'
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def init_opt_state(params: Dict[str, torch.Tensor], config: OptConfig):
    if config.kind == "sgd":
        return {}
    return {
        "mu": {n: torch.zeros_like(p) for n, p in params.items()},
        "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        "count": {n: 0 for n in params},
    }


class Leaf(NamedTuple):
    """One active parameter of an update: its gradient (None: zero), Adam's
    moments (None under SGD) and Adam's step count, already advanced."""
    p: torch.Tensor
    g: Optional[torch.Tensor]
    m: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    count: int


def active_leaves(params: Dict[str, torch.Tensor],
                  grads: Dict[str, Optional[torch.Tensor]], opt_state,
                  active: Dict[str, bool], config: OptConfig) -> List[Leaf]:
    """The leaves of one update, in `params`' order: the active ones alone,
    each Adam count advanced by one."""
    leaves = []
    for name, p in params.items():
        if not active[name]:
            continue
        g = grads.get(name)
        if config.kind == "sgd":
            leaves.append(Leaf(p, g, None, None, 0))
            continue
        c = opt_state["count"][name] + 1
        opt_state["count"][name] = c
        leaves.append(Leaf(p, g, opt_state["mu"][name],
                           opt_state["nu"][name], c))
    return leaves


@torch.no_grad()
def update_plain(leaves: Sequence[Leaf], lr: float, config: OptConfig):
    """One in-place step of each leaf, ATen operation by operation: the
    plain twin of K9 (ops/cuda_optim.py), which the CPU runs."""
    for p, g, m, v, c in leaves:
        if g is None:
            g = torch.zeros_like(p)
        if config.kind == "sgd":
            p.copy_(p - lr * (g + config.weight_decay * p))
            continue
        g = g + config.weight_decay * p
        m.copy_(config.b1 * m + (1 - config.b1) * g)
        v.copy_(config.b2 * v + (1 - config.b2) * (g * g))
        m_hat = m / (1 - config.b1 ** c)
        v_hat = v / (1 - config.b2 ** c)
        p.copy_(p - lr * m_hat / (torch.sqrt(v_hat) + config.eps))


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, Optional[torch.Tensor]], opt_state,
                  active: Dict[str, bool], lr: float, config: OptConfig):
    """One in-place step on every active parameter; a missing or None grad
    counts as zero. Parameters on a CUDA device take K9, on the CPU the
    plain loop. Returns the (updated) optimizer state."""
    global fused_leaves, plain_leaves
    with span("dgod.update"):
        leaves = active_leaves(params, grads, opt_state, active, config)
        if any(leaf.p.is_cuda for leaf in leaves):
            cuda_optim.multi_tensor_update(leaves, lr, config)
            fused_leaves += len(leaves)
        else:
            update_plain(leaves, lr, config)
            plain_leaves += len(leaves)
    return opt_state


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics: mode max, factor 0.1,
    patience 5, threshold 1e-4 rel; reference DGFRCNN.py:105, DGFCOS.py:149)."""

    def __init__(self, factor=0.1, patience=5, threshold=1e-4, min_lr=0.0):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = -float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def is_better(self, metric):
        if self.best == -float("inf"):
            return True
        if self.best > 0:
            return metric > self.best * (1.0 + self.threshold)
        return metric > self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Feed the epoch metric; returns the current lr scale."""
        if self.is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr)
                self.num_bad = 0
        return self.scale


class EarlyStopping:
    """Max-mode early stopping (patience 10, min_delta 0;
    train_driving_dg.py:160)."""

    def __init__(self, patience=10, min_delta=0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = -float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> bool:
        """Returns True if training should stop."""
        if metric > self.best + self.min_delta:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        return self.num_bad >= self.patience
