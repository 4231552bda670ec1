"""Port parity of the DG training steps at small size.

- fused pair steps (0,1) and (0,4) under masked SGD(2e-3, wd 5e-4): the
  port and dgod_tpu's jitted `make_pair_step` start from the same weights,
  batch and random draws, and every parameter after the step agrees to
  rtol 1e-4, and each leaf's update norm-wise to 1e-2;
- each pair moves exactly the groups its two modes activate, including
  active leaves the loss never reaches (they take weight decay), and
  equals mode 0's train step followed by mode k's;
- mode 2's frozen detector: RoIAlign sees features that carry no gradient,
  so on the card its backward kernel (K2) never runs in that half;
- `grad_reverse`: identity forward, -0.1 x gradient backward.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import REG_WEIGHTS, build_pair, jax_draws, tiny_batch, to_torch
from dgod_tpu.models import dg_heads as j_heads
from dgod_tpu.train import steps as j_steps
from dgod_tpu.train.optim import OptConfig as JaxOptConfig
from dgod_tpu_torch.models import dg_heads as t_heads
from dgod_tpu_torch.train import steps as t_steps
from dgod_tpu_torch.utils.weights import params_from_jax

RNG0, RNG1 = jax.random.PRNGKey(3), jax.random.PRNGKey(4)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=2)


@pytest.fixture(scope="module")
def batch():
    return tiny_batch(seed=1)


def _port_pair_step(tm, batch, k, rng0=RNG0, rng1=RNG1):
    opt_config, lr = t_steps.make_optimizer("FRCNN")
    step = t_steps.make_pair_step(tm, k, REG_WEIGHTS, opt_config, lr)
    B = batch["boxes"].shape[0]
    return step({}, to_torch(batch), jax_draws(rng0, tm, B),
                jax_draws(rng1, tm, B))


@pytest.mark.parametrize("k", [1, 4])
def test_pair_step_matches_jax(pair, batch, k):
    jm, jp, tm0 = pair
    tm = copy.deepcopy(tm0)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    _, lr = j_steps.make_optimizer("FRCNN")
    j_step = j_steps.make_pair_step(jm, k, REG_WEIGHTS,
                                    JaxOptConfig("sgd", weight_decay=5e-4),
                                    lr, jp, donate=False)
    j_new, _, j_metrics = j_step(jp, {}, batch, RNG0, RNG1, 1.0)
    _, t_metrics = _port_pair_step(tm, batch, k)

    for name in ("loss0", "loss"):
        np.testing.assert_allclose(float(t_metrics[name]),
                                   float(j_metrics[name]), rtol=1e-4,
                                   atol=1e-7, err_msg=name)
    params = dict(tm.named_parameters())
    # the JAX trees in the port's names and layouts
    j_leaves = params_from_jax(jax.tree.map(np.asarray, j_new))
    j_before = params_from_jax(jax.tree.map(np.asarray, jp))
    for n, p in params.items():
        got = p.detach().numpy()
        ref = j_leaves[n].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7,
                                   err_msg=n)
        # the update itself, norm-wise to 1e-2, beyond the two float32
        # roundings (before, after) of the parameter's value. The worst leaf
        # is image_da.conv1's bias (7e-3): its gradient is a sum of ~1e-9
        # terms that cancel, behind three std-0.001 convs and the GRL; every
        # other leaf agrees to 1e-4.
        p0 = before[n].numpy()
        d_ref = ref.astype(np.float64) - j_before[n].numpy()
        d_got = got.astype(np.float64) - p0
        rounding = np.linalg.norm(2 * np.spacing(np.abs(p0)))
        err = np.linalg.norm(d_got - d_ref)
        assert err <= 1e-2 * np.linalg.norm(d_ref) + rounding, n


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_pair_step_moves_only_active_groups(pair, batch, k):
    _, _, tm0 = pair
    tm = copy.deepcopy(tm0)
    labels = tm.param_group_labels()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    buffers = {n: b.clone() for n, b in tm.named_buffers()}
    _, metrics = _port_pair_step(tm, batch, k)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    moved = {labels[n] for n, p in tm.named_parameters()
             if not torch.equal(before[n], p.detach())}
    expect = set(t_steps.MODE_ACTIVE_GROUPS[0]) | set(
        t_steps.MODE_ACTIVE_GROUPS[k])
    assert moved == expect
    # every leaf of an active group moves, reached by the loss or not
    for n, p in tm.named_parameters():
        if labels[n] in expect:
            assert not torch.equal(before[n], p.detach()), n
    for n, b in tm.named_buffers():
        assert torch.equal(buffers[n], b), n


def test_pair_step_equals_two_train_steps(pair, batch):
    """The fused pair is mode 0's step then mode k's on the same batch."""
    _, _, tm0 = pair
    fused, split = copy.deepcopy(tm0), copy.deepcopy(tm0)
    _port_pair_step(fused, batch, 3)
    opt_config, lr = t_steps.make_optimizer("FRCNN")
    state = {}
    for mode, rng in ((0, RNG0), (3, RNG1)):
        step = t_steps.make_train_step(split, mode, REG_WEIGHTS, opt_config,
                                       lr)
        state, metrics = step(state, to_torch(batch),
                              jax_draws(rng, split, 2))
        assert np.isfinite(float(metrics["loss"]))
    for (n, p), (_, q) in zip(fused.named_parameters(),
                              split.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_roi_align_input_carries_grad_except_in_mode_2(pair, batch, mode,
                                                       monkeypatch):
    _, _, tm0 = pair
    tm = copy.deepcopy(tm0)
    t_steps.stop_inactive_grads(t_steps.mode_set(tm, mode))
    seen = []
    det = tm.detector
    inner = det.roi_align

    def spy(feats, rois):
        seen.append(any(f.requires_grad for f in feats[:4]))
        return inner(feats, rois)

    monkeypatch.setattr(det, "roi_align", spy)
    tm.loss_for_mode(to_torch(batch), jax_draws(RNG0, tm, 2), mode,
                     REG_WEIGHTS)
    assert seen == [mode != 2]


def test_grad_reverse_matches_jax():
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(j_heads.grad_reverse(v) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_heads.grad_reverse(xt)
    assert torch.equal(y.detach(), xt.detach())
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), -0.1 * w, rtol=1e-6)
