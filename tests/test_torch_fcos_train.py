"""Port parity of the DG FCOS training steps under masked Adam, at small
size: the first check of the port's Adam against dgod_tpu's.

Adam's first steps move each element by about lr * sign(g), so an element
whose gradient is within float32 noise of zero moves by +lr in one framework
and -lr in the other. Measured here, the two frameworks' float32 gradients
of one loss differ norm-wise by up to ~1e-3 per leaf (oneDNN's and XLA's
convolutions round differently, and XLA's accuracy changes with the
program it compiles), which flips a few elements of most large leaves. So
the pair step is held to JAX's in two parts that compose to the whole:

- the gradients: for each mode, the port's autograd and `jax.grad` of
  `loss_for_mode` (inactive groups stopped) agree norm-wise to 1e-2 per
  leaf, from the same weights and batch;
- the step: the port's fused pair steps (0,1), (0,2) and (0,4) under
  Adam(1e-4, wd 1e-4), given JAX's gradient of each half, equal JAX's pair
  step (mode 0's update, then mode k's at the updated weights; JAX's
  `apply_updates` with its own gradients): every parameter to rtol 1e-4,
  each leaf's update norm-wise to 1e-2, Adam's moments to rtol 1e-4, and the
  per-leaf step counts exactly, advanced only on the leaves each half
  activates; the losses of both halves agree to rtol 1e-4; and the pair
  matches its gt once (`fcos_match_batched`, kernel K4 on the card), both
  halves taking those codes;
- each pair moves exactly the groups its two modes activate, and equals
  mode 0's train step followed by mode k's.
"""

import copy

import numpy as np
import jax
import pytest
import torch

from _torch_parity import (REG_WEIGHTS, build_fcos_pair, jax_name, tiny_batch,
                           to_torch)
from dgod_tpu.train import optim as j_optim
from dgod_tpu.train import steps as j_steps
from dgod_tpu_torch.ops import matchers as t_matchers
from dgod_tpu_torch.train import optim as t_optim
from dgod_tpu_torch.train import steps as t_steps
from dgod_tpu_torch.utils.weights import params_from_jax

RNG0, RNG1 = jax.random.PRNGKey(3), jax.random.PRNGKey(4)


@pytest.fixture(scope="module")
def pair():
    return build_fcos_pair(seed=2)


@pytest.fixture(scope="module")
def batch():
    return tiny_batch(seed=1)


@pytest.fixture(scope="module")
def jax_grad(pair, batch):
    """mode -> jitted (params, rng) -> (loss, gradient) of JAX's
    `loss_for_mode` with the inactive groups stopped, as JAX's pair step
    takes it (dgod_tpu/train/steps.py::make_pair_step's `half`)."""
    jm, jp, _ = pair
    labels = jm.param_group_labels(jp)
    fns = {}

    def get(mode):
        if mode not in fns:
            active = j_steps.build_active_mask(labels, mode)
            fns[mode] = jax.jit(jax.value_and_grad(
                lambda p, rng: jm.loss_for_mode(
                    j_steps.stop_inactive_grads(p, active), batch, rng, mode,
                    REG_WEIGHTS)[0]))
        return fns[mode]

    return get


def _port_names(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _port_pair_step(tm, batch, k):
    opt_config, lr = t_steps.make_optimizer("FCOS")
    state = t_optim.init_opt_state(dict(tm.named_parameters()), opt_config)
    step = t_steps.make_pair_step(tm, k, REG_WEIGHTS, opt_config, lr)
    return step(state, to_torch(batch), None, None)


def _update_err(got, ref, before):
    """(||(got - before) - (ref - before)||, its allowance: 1e-2 of the
    update's norm beyond the two float32 roundings of the value)."""
    d_ref = ref.astype(np.float64) - before
    d_got = got.astype(np.float64) - before
    rounding = np.linalg.norm(2 * np.spacing(np.abs(before)))
    return (np.linalg.norm(d_got - d_ref),
            1e-2 * np.linalg.norm(d_ref) + rounding)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_fcos_gradients_match_jax(pair, batch, jax_grad, mode):
    _, jp, tm0 = pair
    ref = _port_names(jax_grad(mode)(jp, RNG0)[1])
    tm = copy.deepcopy(tm0)
    mset = t_steps.mode_set(tm, mode)
    t_steps.stop_inactive_grads(mset)
    total, _ = tm.loss_for_mode(to_torch(batch), None, mode, REG_WEIGHTS)
    grads = torch.autograd.grad(total, mset.leaves, allow_unused=True)
    for n, g in zip(mset.names, grads):
        a = ref[n].numpy().astype(np.float64)
        b = np.zeros_like(a) if g is None else g.numpy()
        assert np.isfinite(b).all(), n
        assert np.linalg.norm(b - a) <= 1e-2 * np.linalg.norm(a) + 1e-12, n
    # every inactive leaf takes no gradient on either side (FrozenBatchNorm's
    # tensors, absent from the mask, are buffers in the port)
    for n, g in ref.items():
        if not mset.active.get(n, False):
            assert not g.numpy().any(), n


@pytest.mark.parametrize("k", [1, 2, 4])
def test_adam_pair_step_matches_jax(pair, batch, jax_grad, k, monkeypatch):
    jm, jp, tm0 = pair
    opt_config, lr = j_steps.make_optimizer("FCOS")
    assert opt_config == j_optim.OptConfig("adam", weight_decay=1e-4)
    labels = jm.param_group_labels(jp)
    # JAX's pair step half by half (make_pair_step's `half` for mode 0,
    # then for mode k), keeping each half's loss and gradient
    params, state = jp, j_optim.init_opt_state(jp, opt_config)
    feed, j_losses = [], []
    for mode, rng in ((0, RNG0), (k, RNG1)):
        loss, g = jax_grad(mode)(params, rng)
        feed.append(_port_names(g))
        j_losses.append(float(loss))
        params, state = j_optim.apply_updates(
            params, g, state, j_steps.build_active_mask(labels, mode), lr,
            opt_config)

    # the port's pair step, its two gradient calls answered with JAX's
    tm = copy.deepcopy(tm0)
    before = {n: p.detach().clone().numpy().astype(np.float64)
              for n, p in tm.named_parameters()}
    name_of = {id(p): n for n, p in tm.named_parameters()}
    halves = iter(feed)

    def jax_gradients(total, inputs, allow_unused=False):
        g = next(halves)
        return tuple(g[name_of[id(t)]].clone() for t in inputs)

    matches = []
    fcos_match_batched = t_matchers.fcos_match_batched

    def counted(*args, **kwargs):
        matches.append(args)
        return fcos_match_batched(*args, **kwargs)

    monkeypatch.setattr(t_matchers, "fcos_match_batched", counted)
    monkeypatch.setattr(torch.autograd, "grad", jax_gradients)
    t_state, t_metrics = _port_pair_step(tm, batch, k)
    monkeypatch.undo()
    assert len(matches) == 1  # one match per pair, whatever k

    for name, ref in zip(("loss0", "loss"), j_losses):
        np.testing.assert_allclose(float(t_metrics[name]), ref, rtol=1e-4,
                                   atol=1e-7, err_msg=name)
    j_leaves = _port_names(params)
    j_mu, j_nu = _port_names(state["mu"]), _port_names(state["nu"])
    j_count = {jax_name(path): int(c) for path, c in
               jax.tree_util.tree_flatten_with_path(state["count"])[0]}
    t_labels = tm.param_group_labels()
    worst = (-1.0, "")
    for n, p in tm.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, j_leaves[n].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=n)
        err, allowed = _update_err(got, j_leaves[n].numpy(), before[n])
        assert err <= allowed, n
        if allowed > 0:
            worst = max(worst, (err / allowed, n))
        for moment, ref in (("mu", j_mu), ("nu", j_nu)):
            np.testing.assert_allclose(t_state[moment][n].numpy(),
                                       ref[n].numpy(), rtol=1e-4, atol=1e-12,
                                       err_msg=f"{moment} {n}")
        want = (t_labels[n] in t_steps.MODE_ACTIVE_GROUPS[0]) + (
            t_labels[n] in t_steps.MODE_ACTIVE_GROUPS[k])
        assert t_state["count"][n] == j_count[n] == want, n
    # the worst leaf: its update's error over its allowance
    print(f"pair (0,{k}): worst leaf {worst[1]} at {worst[0]:.3f} of the "
          f"allowance")


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_fcos_pair_step_moves_only_active_groups(pair, batch, k):
    _, _, tm0 = pair
    tm = copy.deepcopy(tm0)
    labels = tm.param_group_labels()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    buffers = {n: b.clone() for n, b in tm.named_buffers()}
    _, metrics = _port_pair_step(tm, batch, k)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    expect = set(t_steps.MODE_ACTIVE_GROUPS[0]) | set(
        t_steps.MODE_ACTIVE_GROUPS[k])
    moved = {labels[n] for n, p in tm.named_parameters()
             if not torch.equal(before[n], p.detach())}
    assert moved == expect
    for n, p in tm.named_parameters():
        if labels[n] in expect:  # every active leaf moves (Adam's wd at least)
            assert not torch.equal(before[n], p.detach()), n
    for n, b in tm.named_buffers():
        assert torch.equal(buffers[n], b), n


def test_fcos_pair_step_equals_two_train_steps(pair, batch):
    """The fused pair is mode 0's step then mode k's on the same batch."""
    _, _, tm0 = pair
    fused, split = copy.deepcopy(tm0), copy.deepcopy(tm0)
    _port_pair_step(fused, batch, 2)
    opt_config, lr = t_steps.make_optimizer("FCOS")
    state = t_optim.init_opt_state(dict(split.named_parameters()), opt_config)
    for mode in (0, 2):
        step = t_steps.make_train_step(split, mode, REG_WEIGHTS, opt_config,
                                       lr)
        state, metrics = step(state, to_torch(batch), None)
        assert np.isfinite(float(metrics["loss"]))
    for (n, p), (_, q) in zip(fused.named_parameters(),
                              split.named_parameters()):
        assert torch.equal(p, q), n
