"""The port LEARNS, on the CPU, in under a minute: its FCOS reaches
train-set mAP@0.5 >= 0.6 within 60 epochs at the size of the JAX learning
smoke test (tests/test_convergence.py: 120x240 images in a 128x256
canvas, 8 per domain, batch 4, ResNet-50 blocks (1,1,1,1)), with its
recipe (FrozenBatchNorm at identity; model seed 0), through the port's
loaders and Trainer (scripts/check_convergence_torch.py). The script's
copy of the generated data equals the JAX script's, array for array, in
both domains, and an init carried between the packages
(scripts/compare_learning_jax_torch.py) survives the round trip bit for
bit. The full-size proof, both families, non_dg and dg, runs on the card
(the script without --smoke).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from scripts import check_convergence as jax_cc  # noqa: E402
from scripts import check_convergence_torch as cc  # noqa: E402


@pytest.mark.parametrize("domain", [0, 1])
def test_shapes_dataset_equals_the_jax_scripts(domain):
    ours = cc.ShapesDataset(8, domain, (120, 240), seed=1)
    ref = jax_cc.ShapesDataset(8, domain, (120, 240), seed=1)
    assert len(ours) == len(ref) == 8
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    assert cc.PALETTE == jax_cc.PALETTE
    assert cc.DOMAIN_TINT == jax_cc.DOMAIN_TINT


def test_fcos_learns_on_cpu(tmp_path, monkeypatch):
    from dgod_tpu_torch.data import transforms as T

    # build_trainer sets the port's transforms geometry in place (script
    # usage): restore it at teardown for the rest of the suite
    for k in ("CANVAS", "TRAIN_SIZE", "MIN_SIZE", "MAX_SIZE", "MIN_AREA"):
        monkeypatch.setattr(T, k, getattr(T, k))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = cc.run_one("FCOS", False, warmup_steps=0,
                            tmpdir=str(tmp_path), device="cpu",
                            calibrate_bn=False, seed=0, **cc.SMOKE)
    finally:
        torch.set_num_threads(threads)
    assert cc.SMOKE["max_epochs"] == 60 and cc.SMOKE["target"] == 0.6
    assert result["reached"], (
        f"train mAP@0.5 stuck at {result['best_map_50']}: {result['curve']}")


@pytest.mark.parametrize("family", ["FCOS", "FRCNN"])
def test_init_carried_between_the_packages(family):
    """The port's init laid out as the JAX tree, and the JAX init as the
    port's state_dict: both exact, so a learning comparison from one init
    runs both packages from the same numbers."""
    from scripts import compare_learning_jax_torch as cmp
    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel
    from dgod_tpu_torch.utils.weights import params_from_jax

    kw = cmp.size_settings("smoke")
    cls = DGFCOSModel if family == "FCOS" else DGFRCNNModel
    model = cls(canvas=kw["canvas"], device="cpu", seed=0,
                backbone_block_counts=kw["block_counts"], **cmp.MODEL_KW)
    template = cmp.jax_init(family, 42, kw)
    tree = cmp.jax_tree_from_torch(template, model.state_dict())
    flat = params_from_jax(tree)
    for k, v in model.state_dict().items():
        assert torch.equal(flat[k], v), k
    model.load_state_dict(params_from_jax(template))
    for k, v in params_from_jax(template).items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("family", ["FCOS", "FRCNN"])
def test_init_distributions_match_jax(family):
    """The port draws its init from the JAX package's distributions: each
    parameter tensor's mean and spread agree with the JAX init's (one draw
    each, so within sampling noise: 10% of the spread for tensors of 4096
    or more entries), and a constant tensor (a zero bias, a unit scale)
    is the same constant."""
    from scripts import compare_learning_jax_torch as cmp
    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel
    from dgod_tpu_torch.utils.weights import params_from_jax

    kw = cmp.size_settings("smoke")
    cls = DGFCOSModel if family == "FCOS" else DGFRCNNModel
    ours = cls(canvas=kw["canvas"], device="cpu", seed=0,
               backbone_block_counts=kw["block_counts"],
               **cmp.MODEL_KW).state_dict()
    ref = params_from_jax(cmp.jax_init(family, 42, kw))
    assert ours.keys() == ref.keys()
    checked = 0
    for k, r in ref.items():
        o = ours[k].float()
        if r.numel() > 1 and float(r.std()) == 0.0:
            assert torch.equal(o, r), k
        elif r.numel() >= 4096:
            s_ref, s_ours = float(r.std()), float(o.std())
            assert abs(s_ours / s_ref - 1.0) < 0.1, (k, s_ours, s_ref)
            assert abs(float(o.mean()) - float(r.mean())) < 0.1 * s_ref, k
            checked += 1
    assert checked > 20
