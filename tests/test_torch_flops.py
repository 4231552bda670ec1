"""The port's FLOP count, MFU and timing (`dgod_tpu_torch.utils.flops`,
`utils.timing`).

- the port's `cycle_flops` equals the JAX package's in every component
  but the stem, and the stem differs by exactly the 7x7x3 conv the port
  runs against the 4x4x12 space-to-depth conv JAX counts;
- `torch.utils.flop_counter.FlopCounterMode` over one port train step
  (ResNet-50 (3,4,6,3), 128x256, batch 2, the small FRCNNConfig of
  tests/test_flops.py) agrees with the analytic count as JAX's jaxpr count
  does there (mode 0 within 7%, mode 2 within 5%), with one term added to
  the expectation: FCOS's eager modes 1-4 compute the head's forward and
  discard it, which JAX's dead-code elimination removed;
- `train_mfu` lies in its band, on the H100's peak or a given one;
- the timing helpers time the CPU on the host clock and refuse a CUDA
  device that is not there.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dgod_tpu.utils import flops as JF
from dgod_tpu_torch.utils import flops as F
from dgod_tpu_torch.utils import timing

CANVAS = (128, 256)
B = 2
REG = (0.5, 0.5, 0.5, 0.05, 1e-4)
SMALL_FRCNN = dict(rpn_pre_nms_train=256, rpn_pre_nms_test=256,
                   rpn_post_nms_train=256, rpn_post_nms_test=256,
                   rpn_batch_per_image=64, box_batch_per_image=64)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stem_difference(canvas):
    h, w = -(-canvas[0] // 2), -(-canvas[1] // 2)
    return (F.conv_flops(h, w, 7, 7, 3, 64)
            - JF.conv_flops(h, w, 4, 4, 12, 64))


@pytest.mark.parametrize("family", ["FRCNN", "FCOS"])
@pytest.mark.parametrize("canvas,batch,rois", [((608, 1216), 8, 512),
                                               (CANVAS, B, 64)])
def test_cycle_flops_equal_jax_but_the_stem(family, canvas, batch, rois):
    ours = F.cycle_flops(family, canvas, batch, num_rois=rois)
    ref = JF.cycle_flops(family, canvas, batch, num_rois=rois)
    stem = _stem_difference(canvas)
    assert stem < 0  # the 7x7x3 conv does less than the 4x4x12 one
    assert (ours["forward"]["backbone"]["stem"]
            - ref["forward"]["backbone"]["stem"]) == stem
    for k in ("layer1", "layer2", "layer3", "layer4"):
        assert ours["forward"]["backbone"][k] == ref["forward"]["backbone"][k]
    assert ours["forward"]["frozen"] - ref["forward"]["frozen"] == stem
    for k in ("trunk", "head"):
        assert ours["forward"][k] == ref["forward"][k]
    assert ours["dg_heads"] == ref["dg_heads"]
    for m in range(5):  # the frozen stem runs forward once in every mode
        assert (ours["per_mode_per_image"][m]
                - ref["per_mode_per_image"][m]) == stem
    assert ours["images_per_cycle"] == ref["images_per_cycle"] == 8 * batch
    assert ours["cycle"] - ref["cycle"] == 8 * batch * stem


def test_train_mfu_band():
    out = F.train_mfu("FCOS", (608, 1216), 8, images_per_sec=200.0)
    assert out["peak_tflops"] == pytest.approx(989.4)
    assert 0.0 < out["mfu"] < 1.0
    assert out["model_tflops_per_sec"] > 0
    # the JAX band (tests/test_flops.py): ~580 GF per image over the cycle
    assert 3e11 < out["flops_per_image"] < 1e12
    assert out["mfu"] == pytest.approx(
        out["model_tflops_per_sec"] * 1e12 / F.H100_SXM_BF16_PEAK_FLOPS)
    # on the v5e's peak the port's count is JAX's less the stem difference
    for family in ("FRCNN", "FCOS"):
        ours = F.train_mfu(family, (608, 1216), 8, 200.0,
                           peak_flops=JF.V5E_BF16_PEAK_FLOPS)
        ref = JF.train_mfu(family, (608, 1216), 8, 200.0)
        assert (ours["flops_per_image"] - ref["flops_per_image"]
                == _stem_difference((608, 1216)))
        assert ours["mfu"] < ref["mfu"]


def _batch():
    rng = np.random.RandomState(0)
    boxes = np.zeros((B, 8, 4), np.float32)
    labels = np.zeros((B, 8), np.int32)
    valid = np.zeros((B, 8), bool)
    boxes[:, 0] = [6, 6, 60, 52]
    labels[:, 0] = 1
    valid[:, 0] = True
    return {
        "image": rng.randint(0, 255, (B, *CANVAS, 3), np.uint8),
        "boxes": boxes,
        "labels": labels,
        "gt_valid": valid,
        "domain": (np.arange(B) % 2).astype(np.int32),
        "image_size": np.tile(np.float32(CANVAS), (B, 1)),
        "scale_back": np.ones((B, 2), np.float32),
    }


@pytest.mark.parametrize("family", ["FCOS", "FRCNN"])
@pytest.mark.parametrize("mode,tol", [(0, 0.07), (2, 0.05)])
def test_flop_counter_matches_the_analytic_count(one_thread, family, mode,
                                                 tol):
    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel, batch_to_torch
    from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.train.optim import init_opt_state

    kw = dict(num_classes=9, num_domains=3, canvas=CANVAS,
              compute_dtype=torch.float32, device="cpu")
    if family == "FCOS":
        model, rois = DGFCOSModel(**kw), 512
    else:
        model = DGFRCNNModel(config=FRCNNConfig(num_classes=9, **SMALL_FRCNN),
                             **kw)
        rois = 64
    opt_config, lr = S.make_optimizer(family)
    step = S.make_train_step(model, mode, REG, opt_config, lr)
    batch = batch_to_torch(_batch(), "cpu")
    draws = model.make_draws(B, 8, torch.Generator().manual_seed(0),
                             with_rpn=mode == 0)
    opt_state = init_opt_state(dict(model.named_parameters()), opt_config)
    with FlopCounterMode(display=False) as counter:
        step(opt_state, batch, draws)
    counted = counter.get_total_flops()
    analytic = F.cycle_flops(family, CANVAS, B, num_rois=rois)[
        "per_mode_per_image"][mode] * B
    if family == "FCOS" and mode != 0:
        # eager PyTorch runs the head forward JAX's count leaves out
        analytic += F.fcos_head_flops(CANVAS) * B
    assert counted > 1e9  # non-vacuous: a real detector step
    assert abs(counted - analytic) <= tol * analytic, (
        f"{family} mode {mode}: counted {counted / 1e9:.2f} GF vs analytic "
        f"{analytic / 1e9:.2f} GF")


def test_timing_on_the_cpu_uses_the_host_clock():
    calls = []
    ms = timing.device_time_ms(lambda: calls.append(1), "cpu", iters=3,
                               warmup=2)
    assert len(calls) == 5 and ms >= 0.0
    out, ms = timing.host_ms(lambda: 7, "cpu")
    assert out == 7 and ms >= 0.0
    assert timing.card("cpu") == "cpu"


def test_timing_never_falls_back_from_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: timing.device_time_ms(lambda: None, "cuda"),
               lambda: timing.host_ms(lambda: None, "cuda"),
               lambda: timing.card("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(ValueError):
        timing.synchronize("meta")
