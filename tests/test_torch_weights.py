"""The port's torchvision warm start (`dgod_tpu_torch.utils.weights`)
against the JAX package's.

Complete torchvision-format state dicts (COCO fasterrcnn_resnet50_fpn,
COCO fcos_resnet50_fpn, ImageNet resnet50), synthesised with numpy from a
seed by tests/test_weights_e2e.py's builders, go through JAX's
`port_torchvision` + `params_from_jax` and through the port's
`port_torchvision` on the same initial weights: the state dicts must be
equal bit for bit. The strictness cases raise as in JAX; the
class-dependent layers are dropped (and keep the init) when their shapes
differ and ported when they match; `Trainer(torch_weights=...)` warm-starts
on the CPU; after loading, the port's forward equals the JAX model's to
the parity tests' tolerance (rtol 1e-4).

Models: full depth (the checkpoints are full ResNet-50s), canvas 64x128,
2 domains, float32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgod_tpu.models.dg_fcos import DGFCOSModel as JaxDGFCOS
from dgod_tpu.models.dg_frcnn import DGFRCNNModel as JaxDGFRCNN
from dgod_tpu.utils import weights as JW
from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel
from dgod_tpu_torch.utils import weights as W
from test_weights_e2e import fcos_sd, frcnn_sd, resnet50_sd

CANVAS = (64, 128)


def _rng():
    return np.random.RandomState(0)


def _build(family):
    jcls, tcls = {"FRCNN": (JaxDGFRCNN, DGFRCNNModel),
                  "FCOS": (JaxDGFCOS, DGFCOSModel)}[family]
    jm = jcls(num_classes=9, num_domains=2, canvas=CANVAS,
              compute_dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = tcls(num_classes=9, num_domains=2, canvas=CANVAS,
              compute_dtype=torch.float32, device="cpu")
    W.load_jax_params(tm, jp)
    return jm, jp, tm


@pytest.fixture(scope="module")
def frcnn():
    return _build("FRCNN")


@pytest.fixture(scope="module")
def fcos():
    return _build("FCOS")


def _imagenet_sd():
    rng = _rng()
    sd = resnet50_sd(rng)
    sd["fc.weight"] = rng.standard_normal((1000, 2048)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal(1000).astype(np.float32)
    return sd


SOURCES = {
    "FRCNN-coco": ("FRCNN", "FRCNN", lambda: frcnn_sd(_rng(), num_cls=91)),
    "FRCNN-10cls": ("FRCNN", "FRCNN", lambda: frcnn_sd(_rng(), num_cls=10)),
    "FCOS-coco": ("FCOS", "FCOS", lambda: fcos_sd(_rng(), num_cls=91)),
    "FCOS-9cls": ("FCOS", "FCOS", lambda: fcos_sd(_rng(), num_cls=9)),
    "FCOS-imagenet": ("FCOS", "resnet", _imagenet_sd),
    "FRCNN-imagenet": ("FRCNN", "resnet", _imagenet_sd),
}


def _both_routes(family, sd, jp, tm):
    """-> (JAX's stats, params_from_jax of JAX's ported tree, the port's
    stats, the ported port model)."""
    tree = jax.tree.map(np.array, jp)  # writable copies
    j_stats = JW.port_torchvision(tree["detector"], sd, family)
    tm = copy.deepcopy(tm)
    t_stats = W.port_torchvision(tm.detector, sd, family)
    return j_stats, W.params_from_jax(tree), t_stats, tm


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_port_equals_jax_port_bit_for_bit(request, source):
    model, family, make = SOURCES[source]
    _, jp, tm = request.getfixturevalue(model.lower())
    sd = make()
    j_stats, want, t_stats, ported = _both_routes(family, sd, jp, tm)
    got = ported.state_dict()
    assert set(got) == set(want)
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    assert diff == [], diff[:5]
    assert t_stats["merged"] == j_stats["merged"]
    assert t_stats["total_leaves"] == len(tm.detector.state_dict())
    assert ([d.replace(".", "/") for d in t_stats["dropped_class_dependent"]]
            == j_stats["dropped_class_dependent"])
    # non-vacuous: everything that was ported moved off the init
    init = tm.detector.state_dict()
    moved = [k for k, v in ported.detector.state_dict().items()
             if not torch.equal(v, init[k])]
    assert len(moved) == t_stats["merged"]


@pytest.mark.parametrize("model,num_cls,layer,dropped", [
    ("FRCNN", 91, "predictor", True), ("FRCNN", 10, "predictor", False),
    ("FCOS", 91, "head.cls_logits", True), ("FCOS", 9, "head.cls_logits",
                                            False)])
def test_class_dependent_layers(request, model, num_cls, layer, dropped):
    _, _, tm = request.getfixturevalue(model.lower())
    make = frcnn_sd if model == "FRCNN" else fcos_sd
    sd = make(_rng(), num_cls=num_cls)
    ported = copy.deepcopy(tm)
    stats = W.port_torchvision(ported.detector, sd, model)
    assert stats["dropped_class_dependent"] == ([layer] if dropped else [])
    assert stats["merged"] == {"FRCNN": 295, "FCOS": 319}[model] - 2 * (
        1 + (model == "FRCNN")) * dropped
    init = tm.detector.state_dict()
    now = ported.detector.state_dict()
    keys = [k for k in now if k.startswith(layer + ".")]
    assert len(keys) == (4 if model == "FRCNN" else 2)
    for k in keys:  # never half-copied: all kept, or all the source's
        if dropped:
            assert torch.equal(now[k], init[k]), k
        else:
            src = {"predictor.cls_score.weight":
                   "roi_heads.box_predictor.cls_score.weight",
                   "predictor.cls_score.bias":
                   "roi_heads.box_predictor.cls_score.bias",
                   "predictor.bbox_pred.weight":
                   "roi_heads.box_predictor.bbox_pred.weight",
                   "predictor.bbox_pred.bias":
                   "roi_heads.box_predictor.bbox_pred.bias",
                   "head.cls_logits.weight":
                   "head.classification_head.cls_logits.weight",
                   "head.cls_logits.bias":
                   "head.classification_head.cls_logits.bias"}[k]
            np.testing.assert_array_equal(now[k].numpy(), sd[src])


def test_fc6_input_permutation():
    """torch flattens the RoI patch CHW, the port HWC: the same input gives
    the same fc6 output."""
    w = np.arange(1024 * 12544, dtype=np.float32).reshape(1024, 12544) % 97
    out = W.convert_frcnn_state_dict({"roi_heads.box_head.fc6.weight": w})
    k = out["box_head.fc6.weight"].numpy()  # [1024, 12544], input HWC
    x = np.zeros((256, 7, 7), np.float32)
    x[5, 2, 3] = 1.0
    x[200, 6, 0] = 2.0
    np.testing.assert_array_equal(w @ x.reshape(-1),
                                  k @ x.transpose(1, 2, 0).reshape(-1))


def test_both_rpn_conv_spellings(frcnn):
    _, _, tm = frcnn
    sd = frcnn_sd(_rng())
    nested = dict(sd)
    nested["rpn.head.conv.0.0.weight"] = nested.pop("rpn.head.conv.weight")
    nested["rpn.head.conv.0.0.bias"] = nested.pop("rpn.head.conv.bias")
    a, b = copy.deepcopy(tm), copy.deepcopy(tm)
    W.port_torchvision(a.detector, sd, "FRCNN")
    W.port_torchvision(b.detector, nested, "FRCNN")
    for k in ("rpn_head.conv.weight", "rpn_head.conv.bias"):
        assert torch.equal(a.detector.state_dict()[k],
                           b.detector.state_dict()[k])
        np.testing.assert_array_equal(a.detector.state_dict()[k].numpy(),
                                      sd["rpn.head." + k[9:]])


def _renamed(sd):
    sd["backbone.body.layer2.1.conv2_renamed.weight"] = sd.pop(
        "backbone.body.layer2.1.conv2.weight")


def _garbage(sd):
    sd["some.future.module.weight"] = np.zeros((2, 2), np.float32)


def _bad_shape(sd):
    sd["rpn.head.conv.weight"] = sd["rpn.head.conv.weight"][:, :128]


@pytest.mark.parametrize("edit,match", [
    (_renamed, "did not consume"), (_garbage, "did not consume"),
    (_bad_shape, "shape mismatch")])
def test_strictness_raises_as_in_jax(frcnn, edit, match):
    _, jp, tm = frcnn
    sd = frcnn_sd(_rng())
    edit(sd)
    with pytest.raises(ValueError, match=match):
        JW.port_torchvision(jax.tree.map(np.array, jp)["detector"], sd,
                            "FRCNN")
    ported = copy.deepcopy(tm)
    with pytest.raises(ValueError, match=match):
        W.port_torchvision(ported.detector, sd, "FRCNN")
    # nothing was copied before the check
    for k, v in tm.state_dict().items():
        assert torch.equal(ported.state_dict()[k], v), k


def test_converted_tensor_without_destination_raises():
    """A full ResNet-50 checkpoint into a model cut to (1,1,1,1) blocks:
    the deeper blocks have no destination."""
    tm = DGFCOSModel(num_classes=9, num_domains=2, canvas=CANVAS,
                     compute_dtype=torch.float32,
                     backbone_block_counts=(1, 1, 1, 1), device="cpu")
    with pytest.raises(ValueError, match="no destination"):
        W.port_torchvision(tm.detector, _imagenet_sd(), "resnet")


def test_unknown_family_raises(fcos):
    with pytest.raises(ValueError, match="unknown family"):
        W.port_torchvision(fcos[2].detector, {}, "RetinaNet")


def _save(path, sd, wrap=False):
    tensors = {k: torch.from_numpy(np.atleast_1d(np.asarray(v)))
               for k, v in sd.items()}
    if wrap:  # a Lightning checkpoint of the reference's detector module
        tensors = {"state_dict": {f"detector.{k}": v
                                  for k, v in tensors.items()},
                   "epoch": 3}
    torch.save(tensors, path)


def test_load_torch_file_strips_the_lightning_wrapper(tmp_path):
    sd = fcos_sd(_rng())
    _save(tmp_path / "plain.pth", sd)
    _save(tmp_path / "lightning.ckpt", sd, wrap=True)
    plain = W.load_torch_file(str(tmp_path / "plain.pth"))
    wrapped = W.load_torch_file(str(tmp_path / "lightning.ckpt"))
    assert set(plain) == set(wrapped) == set(sd)
    for k in sd:
        assert torch.equal(plain[k], wrapped[k])
    assert W.torchvision_family(plain, "FCOS") == "FCOS"
    assert W.torchvision_family(_imagenet_sd(), "FCOS") == "resnet"


@pytest.mark.parametrize("source", ["FCOS-coco", "FCOS-imagenet"])
def test_trainer_warm_starts_from_torch_weights(tmp_path, fcos, source):
    from dgod_tpu_torch.train.harness import Trainer

    _, family, make = SOURCES[source]
    sd = make()
    path = str(tmp_path / "init.pth")
    _save(path, sd)
    _, _, tm = fcos
    model = copy.deepcopy(tm)
    tr = Trainer(model, None, None, dg=False, max_epochs=0,
                 ckpt_path=str(tmp_path / "x.ckpt"), torch_weights=path,
                 device="cpu")
    stem = "conv1.weight" if family == "resnet" else \
        "backbone.body.conv1.weight"
    np.testing.assert_array_equal(
        tr.model.state_dict()["detector.backbone.body.conv1.weight"].numpy(),
        sd[stem])
    want = copy.deepcopy(tm)
    W.port_torchvision(want.detector, sd, family)
    for k, v in want.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    # Adam's moments are built after the load, for the loaded parameters
    assert set(tr.opt_state["mu"]) == {n for n, _ in model.named_parameters()}

    # a checkpoint to resume from wins: the .pth is not read again
    tr.store.save(0, tm.state_dict(), tr.opt_state, {"val_acc": 0.5})
    again = Trainer(copy.deepcopy(tm), None, None, dg=False, max_epochs=0,
                    ckpt_path=str(tmp_path / "x.ckpt"),
                    torch_weights=str(tmp_path / "missing.pth"), device="cpu")
    assert torch.equal(
        again.model.state_dict()["detector.backbone.body.conv1.weight"],
        tm.state_dict()["detector.backbone.body.conv1.weight"])


def test_forward_after_loading_matches_jax_frcnn(frcnn):
    jm, jp, tm = frcnn
    sd = frcnn_sd(_rng())
    tree = jax.tree.map(np.array, jp)
    JW.port_torchvision(tree["detector"], sd, "FRCNN")
    ported = copy.deepcopy(tm)
    W.port_torchvision(ported.detector, sd, "FRCNN")
    images = np.random.RandomState(1).randint(
        0, 255, (2, *CANVAS, 3)).astype(np.float32) / 255.0
    j_feats, _ = jax.jit(jm.detector.features)(tree["detector"],
                                               jnp.asarray(images))
    with torch.no_grad():
        t_feats, _ = ported.detector.features(torch.from_numpy(images))
    assert len(t_feats) == len(j_feats) == 5
    for lvl, (a, b) in enumerate(zip(j_feats, t_feats)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5, err_msg=f"P{lvl + 2}")


def test_forward_after_loading_matches_jax_fcos(fcos):
    jm, jp, tm = fcos
    sd = fcos_sd(_rng())
    tree = jax.tree.map(np.array, jp)
    JW.port_torchvision(tree["detector"], sd, "FCOS")
    ported = copy.deepcopy(tm)
    W.port_torchvision(ported.detector, sd, "FCOS")
    images = np.random.RandomState(1).randint(
        0, 255, (2, *CANVAS, 3)).astype(np.uint8)
    j_out, _ = jax.jit(jm.forward)(tree, jnp.asarray(images))
    with torch.no_grad():
        t_out, _ = ported(torch.from_numpy(images))
    for name in ("cls_logits", "bbox_regression", "bbox_ctrness"):
        np.testing.assert_allclose(t_out[name].numpy(),
                                   np.asarray(j_out[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
