"""Port parity of the DG FCOS at small size: weights carried across, the
backbone's P3..P7 and C5, the head's outputs and location features, the
five DG losses under both loss configurations, postprocess and predict.

One JAX DGFCOSModel (float32, canvas 128x256, block counts (1,1,1,1), 2
domains, MAX_GT 8) and its port loaded with the same weights through
`params_from_jax`. FCOS draws nothing at random, so the losses agree to
float32 rounding: rtol 1e-4 for features, head outputs, losses, boxes and
scores; labels and validity exactly. The batch has a one-gt image, so the
`single_gt_quirk` configuration takes its zero-target branch.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (CANVAS, NUM_DOMAINS, REG_WEIGHTS, build_fcos_pair,
                           jax_name, tiny_batch, to_torch)
from dgod_tpu.models import fcos as j_fcos
from dgod_tpu.models.backbone import FCOSBackbone as JaxFCOSBackbone
from dgod_tpu.models.dg_fcos import IMAGENET_MEAN, IMAGENET_STD
from dgod_tpu.models.dg_fcos import DGFCOSModel as JaxDGFCOS
from dgod_tpu.models.fcos import FCOSLossConfig as JaxLossConfig
from dgod_tpu_torch.models import fcos as t_fcos
from dgod_tpu_torch.models.fcos import FCOSLossConfig
from dgod_tpu_torch.utils.weights import load_jax_params, params_from_jax

RNG = jax.random.PRNGKey(1)
QUIRKS = dict(exact_reference_area=True, single_gt_quirk=True)


@pytest.fixture(scope="module")
def pair():
    return build_fcos_pair(seed=0)


@pytest.fixture(scope="module")
def quirk_pair(pair):
    """The same weights under FCOSLossConfig(exact area, single-gt quirk)."""
    _, jp, tm = pair
    jm = JaxDGFCOS(num_classes=9, num_domains=NUM_DOMAINS, canvas=CANVAS,
                   loss_config=JaxLossConfig(**QUIRKS),
                   compute_dtype=jnp.float32, backbone_block_counts=(1, 1, 1, 1))
    tq = copy.deepcopy(tm)
    tq.loss_config = FCOSLossConfig(**QUIRKS)
    return jm, jp, tq


def fcos_batch(seed=0):
    """Three images: two gt, three gt, one gt."""
    batch = tiny_batch(b=3, seed=seed)
    batch["gt_valid"][2, 1] = False
    return batch


@pytest.fixture(scope="module")
def batch():
    return fcos_batch()


@pytest.fixture(scope="module")
def forwards(pair, batch):
    jm, jp, tm = pair
    ref = jax.jit(jm.forward)(jp, batch["image"])
    with torch.no_grad():
        got = tm(to_torch(batch)["image"])
    return ref, got


def _tree(jp):
    return jax.tree.map(np.asarray, jp)


# -- weights -----------------------------------------------------------------

def test_params_from_jax_covers_the_fcos_state_dict(pair):
    _, jp, tm = pair
    sd = params_from_jax(_tree(jp))
    own = tm.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    head = jp["detector"]["head"]
    w = np.asarray(head["cls_conv0"]["kernel"])
    np.testing.assert_array_equal(sd["detector.head.cls_conv0.weight"],
                                  w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["detector.head.reg_gn3.scale"],
                                  np.asarray(head["reg_gn3"]["scale"]))
    np.testing.assert_array_equal(
        sd["detector.backbone.p6p7.p7.weight"],
        np.asarray(jp["detector"]["backbone"]["p6p7"]["p7"]["kernel"])
        .transpose(3, 2, 0, 1))
    # GroupNorm's scale and bias are trainable parameters (FrozenBatchNorm's
    # are buffers)
    params = dict(tm.named_parameters())
    assert "detector.head.cls_gn0.scale" in params
    assert "detector.head.cls_gn0.bias" in params
    assert tm.param_group_labels()["detector.head.cls_gn0.scale"] == "detector"


@pytest.mark.parametrize("bad", ["gn_leaf", "head_leaf", "top"])
def test_params_from_jax_refuses_unknown_fcos_leaves(pair, bad):
    _, jp, tm = pair
    tree = _tree(jp)
    if bad == "gn_leaf":
        tree["detector"]["head"]["cls_gn0"]["offset"] = np.zeros(256,
                                                                 np.float32)
        err = KeyError
    elif bad == "head_leaf":
        tree["detector"]["head"]["extra"] = {"kernel": np.zeros((2, 2),
                                                                np.float32)}
        err = RuntimeError  # a name the port's state_dict does not have
    else:
        tree["stray"] = {"bias": np.zeros(2, np.float32)}
        err = KeyError
    with pytest.raises(err):
        load_jax_params(copy.deepcopy(tm), tree)


def test_fcos_param_group_labels_match_jax(pair):
    jm, jp, tm = pair
    j_labels = {jax_name(path): lbl for path, lbl in
                jax.tree_util.tree_flatten_with_path(
                    jm.param_group_labels(jp))[0]}
    t_labels = tm.param_group_labels()
    buffers = set(tm.state_dict()) - set(t_labels)
    assert set(t_labels) == set(j_labels) - buffers
    assert all(j_labels[n] == "frozen" for n in buffers)
    for n, lbl in t_labels.items():
        assert lbl == j_labels[n], n


# -- backbone and head -------------------------------------------------------------

def test_backbone_levels_and_c5_match_jax(pair, batch):
    _, jp, tm = pair
    x = (batch["image"].astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    j_feats, j_c = jax.jit(JaxFCOSBackbone(
        dtype=jnp.float32, block_counts=(1, 1, 1, 1)).apply)(
        {"params": jp["detector"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        t_feats, t_c = tm.detector.features(torch.from_numpy(x))
    assert len(t_feats) == len(j_feats) == 5
    for lvl, (a, b) in enumerate(zip(j_feats, t_feats)):
        assert tuple(b.shape) == a.shape, lvl
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5, err_msg=f"P{lvl + 3}")
    np.testing.assert_allclose(t_c["c5"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_c["c5"]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["cls_logits", "bbox_regression",
                                  "bbox_ctrness", "ins_feat", "c5"])
def test_head_outputs_match_jax(forwards, name):
    (j_out, j_aux), (t_out, t_aux) = forwards
    ref = j_out[name] if name in j_out else j_aux[name]
    got = t_out[name] if name in t_out else t_aux[name]
    assert tuple(got.shape) == ref.shape
    if name != "c5":
        R = sum(t_fcos.fcos_anchors_for(CANVAS)[1])
        assert got.shape[1] == R  # locations P3..P7, (y, x) order each
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


# -- the five DG losses ------------------------------------------------------

@pytest.mark.parametrize("config", ["default", "quirks"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_loss_for_mode_matches_jax(pair, quirk_pair, batch, config, mode):
    jm, jp, tm = pair if config == "default" else quirk_pair
    j_total, j_metrics = jax.jit(lambda p, b: jm.loss_for_mode(
        p, b, RNG, mode, REG_WEIGHTS))(jp, batch)
    assert tm.make_draws(3, 8, torch.Generator()) is None
    t_total, t_metrics = tm.loss_for_mode(to_torch(batch), None, mode,
                                          REG_WEIGHTS)
    assert set(t_metrics) == set(j_metrics)
    assert np.isfinite(float(t_total.detach()))
    np.testing.assert_allclose(float(t_total.detach()), float(j_total),
                               rtol=1e-4, atol=1e-7)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(t_metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_mode0_gradients_are_finite_with_a_no_gt_image(pair, batch):
    """An image without gt: every location's regression target is the zero
    padding, and a zero prediction at a location whose centre is on the
    canvas edge gives GIoU an empty enclosing box. The port's gradient is
    finite there; the reference's is NaN (ROADMAP Queue C)."""
    jm, jp, tm0 = pair
    b = copy.deepcopy(batch)
    b["gt_valid"][0] = False
    b["boxes"][0] = 0.0
    tm = copy.deepcopy(tm0)
    total, _ = tm.loss_for_mode(to_torch(b), None, 0, REG_WEIGHTS)
    params = [p for n, p in tm.named_parameters() if n.startswith("detector")]
    grads = torch.autograd.grad(total, params, allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    assert any(g is not None and g.abs().sum() > 0 for g in grads)
    j_grads = jax.jit(jax.grad(lambda p: jm.loss_for_mode(
        p, b, RNG, 0, REG_WEIGHTS)[0]))(jp)
    j_finite = all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(j_grads["detector"]))
    assert not j_finite


# -- postprocess and predict -------------------------------------------------

def test_fcos_postprocess_matches_jax():
    """Synthetic head outputs: most scores above the 0.2 threshold, logits
    quantised so that many scores tie, per-image sizes and scales."""
    rng = np.random.RandomState(4)
    anchors, counts = t_fcos.fcos_anchors_for(CANVAS)
    B, R, C = 2, anchors.shape[0], 9
    outputs = {
        "cls_logits": (np.round(rng.randn(B, R, C) * 4) / 4 + 0.5)
        .astype(np.float32),
        "bbox_regression": rng.uniform(0, 3, (B, R, 4)).astype(np.float32),
        "bbox_ctrness": (np.round(rng.randn(B, R, 1) * 2) / 2)
        .astype(np.float32),
    }
    sizes = np.array([[128, 256], [100, 180]], np.float32)
    scales = np.array([[1.0, 1.0], [2.5, 1.5]], np.float32)
    ref = j_fcos.fcos_postprocess(
        {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(anchors),
        counts, jnp.asarray(sizes), jnp.asarray(scales))
    got = t_fcos.fcos_postprocess(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        torch.from_numpy(anchors), counts, torch.from_numpy(sizes),
        torch.from_numpy(scales))
    _compare_detections(ref, got)
    assert got["valid"].all()  # many survivors: all 100 slots filled


def _compare_detections(ref, got):
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(ref["boxes"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), rtol=1e-4,
                               atol=1e-7)


def test_predict_matches_jax(pair, batch):
    """The cls_logits bias is raised by 4 in the JAX tree before it is
    carried across, so that detections pass the 0.2 score threshold."""
    jm, jp, tm0 = pair
    head = dict(jp["detector"]["head"])
    head["cls_logits"] = dict(head["cls_logits"],
                              bias=head["cls_logits"]["bias"] + 4.0)
    jp = dict(jp, detector=dict(jp["detector"], head=head))
    tm = copy.deepcopy(tm0)
    load_jax_params(tm, _tree(jp))
    ref = jax.jit(jm.predict)(jp, batch)
    got = tm.predict(to_torch(batch))
    _compare_detections(ref, got)
    valid = got["valid"].numpy()
    assert valid.sum() > 50
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "boxes": (3, 100, 4), "scores": (3, 100), "labels": (3, 100),
        "valid": (3, 100)}
