"""The yardstick's frozen copies held to the port's originals: the FLOP
model, the input generators and the FrozenBatchNorm calibration, the
profiler categories, the timing arithmetic, the kernel work counts' shapes,
and the plain reference against the port's plain path."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.bench import flops, kernels, models, synthetic, timing
from perfbench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("family", ["FRCNN", "FCOS"])
@pytest.mark.parametrize("canvas", [(608, 1216), (64, 128)])
def test_perfbench_flops_equal_the_port(family, canvas):
    from dgod_tpu_torch.utils import flops as port

    for b in (1, 8):
        assert flops.cycle_flops(family, canvas, b) == port.cycle_flops(
            family, canvas, b)
    for rois in (512, 1000):
        assert flops.family_forward_flops(family, canvas, rois) == \
            port.family_forward_flops(family, canvas, rois)
    assert flops.H100_SXM_BF16_PEAK_FLOPS == port.H100_SXM_BF16_PEAK_FLOPS
    assert kernels.BF16_PEAK_FLOPS == port.H100_SXM_BF16_PEAK_FLOPS
    assert kernels.HBM_BYTES_PER_S == port.H100_SXM_HBM_BYTES_PER_S


@pytest.mark.parametrize("name", ["synthetic_batch", "dense_gt_batch"])
def test_perfbench_generators_equal_the_port(name):
    from dgod_tpu_torch.utils import synthetic as port

    for seed in (0, 7, 2**32 - 1):
        a = getattr(synthetic, name)(np.random.RandomState(seed), 3,
                                     (608, 1216), 3)
        b = getattr(port, name)(np.random.RandomState(seed), 3,
                                (608, 1216), 3)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_perfbench_pngs_equal_the_port():
    from dgod_tpu_torch.utils import synthetic as port

    for a, b in zip(synthetic.scene_pngs(3, (40, 72), seed=4),
                    port.scene_pngs(3, (40, 72), seed=4)):
        assert a[0] == b[0] and a[2:] == b[2:]
        np.testing.assert_array_equal(a[1], b[1])


def test_perfbench_calibration_equals_the_port():
    from dgod_tpu_torch.utils import synthetic as port

    config = tiny_cell("frcnn-dg_train")["config"]
    images = torch.from_numpy(synthetic.dense_gt_batch(
        np.random.RandomState(1), 2, (64, 128), 3, max_gt=32)["image"])
    state = models.make_state(config, 3, torch.device("cpu"), images)
    ref = models.reference_model(config, "cpu")
    prog = models.program_model(config, "cpu")
    models.load_state(ref, state)
    models.load_state(prog, state)
    synthetic.calibrate_frozen_bn(ref, images)
    port.calibrate_frozen_bn(prog, images)
    for (n, a), (m, b) in zip(ref.named_buffers(), prog.named_buffers()):
        assert n == m
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _literal(path: Path, name: str):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_perfbench_categories_equal_the_port():
    assert kernels.CATEGORIES == _literal(
        ROOT / "scripts" / "profile_torch_pairs.py", "CATEGORIES")


def test_perfbench_kernel_shapes_equal_the_port():
    """The anchor counts the work counts use are the models' own; K5's
    per-level entries are chip_smoke.py's at 608x1216."""
    from dgod_tpu_torch.models.faster_rcnn import FRCNNDetector
    from dgod_tpu_torch.models.fcos import fcos_anchors_for

    canvas = (608, 1216)
    det = FRCNNDetector(canvas=canvas, backbone_block_counts=(1, 1, 1, 1))
    assert list(det.anchor_counts) == kernels.frcnn_anchor_counts(canvas)
    assert list(fcos_anchors_for(canvas)[1]) == kernels.fcos_anchor_counts(
        canvas)
    smoke = ROOT / "chip_smoke.py"
    train = _literal(smoke, "TRAIN_LEVELS")
    predict = _literal(smoke, "PREDICT_LEVELS")
    counts = kernels.frcnn_anchor_counts(canvas)
    assert tuple(min(2000, c) for c in counts) == train
    assert tuple(min(1000, c) for c in counts) == predict
    config = tiny_cell("frcnn-dg_train")["config"]
    config["canvas"] = list(canvas)
    config["frcnn"].update(rpn_pre_nms_train=2000, box_batch_per_image=512)
    # chip_smoke's K5 row: 8 x 8570 entries of 49 bytes, 30 ops each
    assert kernels.launch_work("K5", "train", config, 8, 128) == (
        8 * 8570 * 49 + 64, 30 * 8 * 8570)
    # its K1 row without the data-dependent feature cells
    n = 8 * 512
    assert kernels.launch_work("K1", "train", config, 8, 128) == (
        n * 49 * 256 * 4 + n * 16, n * 49 * 4 * 8 * 256)


def _function(path: Path, name: str):
    """The function `name` of `path` as ast gives it."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    raise KeyError(name)


def _body(node) -> str:
    """A function's statements, its docstring left out, as ast.dump gives
    them."""
    body = node.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def _calls(node, name: str) -> list:
    return [ast.dump(c) for c in ast.walk(node) if isinstance(c, ast.Call)
            and getattr(c.func, "attr", getattr(c.func, "id", None)) == name]


def test_perfbench_timing_equals_the_port():
    """host_ms is the port's, statement for statement; card runs the same
    nvidia-smi query and takes the same line of it."""
    port = ROOT / "dgod_tpu_torch" / "utils" / "timing.py"
    mine = Path(timing.__file__)
    assert _body(_function(mine, "host_ms")) == _body(
        _function(port, "host_ms"))
    card_mine, card_port = _function(mine, "card"), _function(port, "card")
    assert _calls(card_mine, "run") == _calls(card_port, "run") != []
    assert ast.dump(card_mine.body[-1]) == ast.dump(card_port.body[-1])
    out, ms = timing.host_ms(lambda: 3, "cpu")
    assert out == 3 and ms >= 0


@pytest.mark.parametrize("name", ["frcnn-dg_train", "fcos-dg_train"])
def test_perfbench_reference_equals_the_plain_port(name):
    """On the CPU the port runs its plain versions: from one state, on one
    batch and one set of draws, the frozen reference's pair step gives the
    same losses and parameters, bit for bit."""
    from perfbench.bench import train
    from perfbench.bench.common import Spans

    cell = tiny_cell(name)
    s = train.setup(cell, 11, torch.device("cpu"), Spans(False))
    ref = train.reference_readings(s.config, torch.device("cpu"), s.state,
                                   s.plan)
    assert ref["losses"] == s.readings["losses"]
    assert ref["g1"] == s.readings["g1"] and ref["d3"] == s.readings["d3"]


def test_perfbench_reference_predict_equals_the_plain_port():
    from perfbench.bench import predict
    from perfbench.bench.common import Spans

    cell = tiny_cell("frcnn-predict_b1")
    s = predict.setup(cell, 11, torch.device("cpu"), Spans(False))
    ref = predict.reference_detections(s.config, torch.device("cpu"),
                                       s.state, s.requests)
    for j in range(len(s.requests)):
        got = s.request(j, Spans(False))
        for k in ref[j]:
            np.testing.assert_array_equal(got[k].numpy(), ref[j][k])
