"""The port's measurement entry points on the CPU (their card runs are
chip_smoke.py's phase 13):

- each script's `--device cpu` smoke run (64x128 canvas, blocks
  (1,1,1,1), batch 2, 1-4 steps or calls) prints one JSON line whose
  numbers are finite; without a card and without `--device cpu` each
  exits non-zero and prints nothing;
- the e2e counts `steps x 2 x batch` images and its occupancy is
  e2e_ips / device_ips, with either loader;
- the eval sweep's mAP is a direct `Trainer.validate`'s on the same
  batches (tests/test_torch_harness.py holds that one to JAX's);
- the unfused DG cycle is 4 x mode 0 + modes 1-4;
- the roofline's per-stage bytes are the JAX script's `conv_bytes` /
  `stage_traffic` at the same shapes, its FLOPs the JAX package's per
  stage but the stem (the port runs the 7x7 conv) and
  `FlopCounterMode`'s;
- `profile_steps` writes a non-empty trace that names an aten
  convolution;
- the dataset writer reuses only files made with the same parameters,
  and its PNGs and CSV read back through `DrivingDataset`;
- `dense_gt_batch` is the JAX eval script's batch at 608x1216.
"""

import contextlib
import io
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from scripts import bench_detail_torch, bench_e2e_torch  # noqa: E402
from scripts import bench_eval as jax_eval  # noqa: E402
from scripts import bench_eval_torch, roofline_backbone_torch  # noqa: E402
from scripts import roofline_backbone as jax_roof  # noqa: E402

from dgod_tpu.utils import flops as JF  # noqa: E402
from dgod_tpu_torch.data.dataset import DrivingDataset  # noqa: E402
from dgod_tpu_torch.utils import synthetic  # noqa: E402
from dgod_tpu_torch.utils.logging import profile_steps  # noqa: E402

SCRIPTS = {"detail": bench_detail_torch, "eval": bench_eval_torch,
           "e2e": bench_e2e_torch, "roofline": roofline_backbone_torch}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_main(module, argv):
    """`module.main(argv)` -> (exit code, its stdout's lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue().splitlines()


def smoke(module, argv):
    rc, lines = run_main(module, ["--device", "cpu", *argv])
    assert rc == 0 and len(lines) == 1, lines
    out = json.loads(lines[0])
    assert out["device"] == "cpu" and out["card"] == "cpu"
    assert_finite(out)
    return out


def assert_finite(obj, path=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            assert_finite(v, f"{path}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            assert_finite(v, f"{path}[{i}]")
    elif isinstance(obj, float):
        assert math.isfinite(obj), path


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_without_a_card_exits_nonzero_and_prints_nothing(
        name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines = run_main(SCRIPTS[name], [])
    assert rc != 0 and lines == []


def test_bench_detail_smoke_times_every_unfused_mode():
    out = smoke(bench_detail_torch, ["--iters", "1"])
    for family in ("FRCNN", "FCOS"):
        got = out["families"][family]
        modes = {int(m): ms for m, ms in got["mode_ms"].items()}
        assert sorted(modes) == [0, 1, 2, 3, 4]
        assert got["cycle_ms"] == pytest.approx(
            4 * modes[0] + sum(modes[m] for m in (1, 2, 3, 4)))
        assert got["cycle_images"] == 8 * out["batch"]
        # one warm-up and one timed call per mode; a warm-up, one
        # host-timed and 1 + 1 device-timed predicts
        assert got["calls"] == {**{f"mode{m}": 2 for m in range(5)},
                                "predict": 4}
        assert all(3 <= n <= 29 for n in got["gt_per_image"])


def test_bench_eval_smoke_sweep_is_trainer_validate():
    out = smoke(bench_eval_torch, ["--iters", "1", "--sweep_batches", "3",
                                   "--family", "FRCNN"])
    got = out["families"]["FRCNN"]
    assert got["sweep_batches"] == 3 and got["sweep_images_per_sec"] > 0
    assert list(got["stages"]) == ["batch1", "batch2"]
    assert list(got["stages"]["batch2"]) == [
        "backbone+FPN", "+RPN heads", "+proposal decode/NMS (K5)",
        "+RoIAlign (K1)", "+box head", "+postprocess (K6)"]
    size = synthetic.SIZES["cpu"]
    model, _ = synthetic.sized_model("FRCNN", "cpu", size)
    batches = bench_eval_torch.eval_batches(3, size["batch"],
                                            size["canvas"])
    direct = bench_eval_torch.make_trainer(model, batches, "cpu",
                                           "unused").validate()
    assert got["sweep_map_50"] == direct["map_50"]


def test_bench_eval_smoke_fcos_stages():
    out = smoke(bench_eval_torch, ["--iters", "1", "--sweep_batches", "2",
                                   "--family", "FCOS"])
    got = out["families"]["FCOS"]
    assert list(got["stages"]["batch1"]) == ["forward", "+postprocess (K6)"]
    for key in ("batch1_ms_per_image_host", "batch2_ms_per_image_device",
                "copy_ms_host"):
        assert got[key] > 0


@pytest.mark.parametrize("loader", ["threads", "process"])
def test_bench_e2e_smoke_counts_images_and_occupancy(loader, tmp_path):
    argv = ["--steps", "2", "--images", "8", "--workers", "2",
            "--data_dir", str(tmp_path / "pngs")]
    if loader == "process":
        argv += ["--process_loader", "--decode_cache_gb", "0.01"]
    out = smoke(bench_e2e_torch, argv)
    assert out["images"] == out["pair_steps"] * 2 * out["batch"] == 8
    assert out["occupancy"] == out["e2e_ips"] / out["device_ips"]
    assert out["process_loader"] == (loader == "process")
    # 4 warm-up pairs (0,1)..(0,4), then the e2e's (0,1) (0,2) and the
    # device-only (0,3) (0,4): the schedule runs on across the three
    assert out["calls"] == {"pair1": 2, "pair2": 2, "pair3": 2, "pair4": 2}
    assert out["source_hw"] == [128, 256]


def test_roofline_smoke_counts_agree_with_flop_counter():
    out = smoke(roofline_backbone_torch, ["--iters", "1"])
    names = [r["name"] for r in out["stages"]]
    assert names == ["stem (7x7/2 conv + pool)", "layer1 (1x w64 s4)",
                     "layer2 (1x w128 s8)", "layer3 (1x w256 s16)",
                     "layer4 (1x w512 s32)", "FRCNN FPN", "rpn conv @P2",
                     "FCOS FPN", "fcos tower @P3 (4conv)"]
    for row in out["stages"]:
        assert row["flop_counter_gflops"] == row["gflops"]
        assert row["share"] is None  # no card: no share of its bound
        # the frozen stem and layer1 have no backward in training
        assert row["trainable"] == (not row["name"].startswith(
            ("stem", "layer1")))
        assert (row["fwd_bwd_ms"] is not None) == row["trainable"]


def test_roofline_traffic_and_flops_are_the_jax_scripts():
    H, W = jax_roof.CANVAS
    b = jax_roof.B
    rows = {r["name"].split(" ")[0]: r for r in
            roofline_backbone_torch.stage_table("FRCNN", (H, W), b)
            + roofline_backbone_torch.stage_table("FCOS", (H, W), b,
                                                  backbone=False)}
    h4, w4, h8, w8 = H // 4, W // 4, H // 8, W // 8
    want = {
        "layer1": jax_roof.stage_traffic(h4, w4, 64, 64, 3, 1),
        "layer2": jax_roof.stage_traffic(h4, w4, 256, 128, 4, 2),
        "layer3": jax_roof.stage_traffic(h8, w8, 512, 256, 6, 2),
        "layer4": jax_roof.stage_traffic(H // 16, W // 16, 1024, 512, 3, 2),
        "rpn": jax_roof.conv_bytes(h4, w4, h4, w4, 3, 256, 256),
        "fcos": 4 * jax_roof.conv_bytes(h8, w8, h8, w8, 3, 256, 256),
        # the port's stem conv, in the same traffic model
        "stem": jax_roof.conv_bytes(H, W, H // 2, W // 2, 7, 3, 64)
        + 2.0 * (H // 2) * (W // 2) * 64 * b,
    }
    for name, nbytes in want.items():
        assert rows[name]["bytes"] == nbytes, name
    jax_bb = JF.resnet50_flops((H, W))
    for s in (1, 2, 3, 4):
        assert rows[f"layer{s}"]["flops"] == jax_bb[f"layer{s}"] * b
    assert rows["rpn"]["flops"] == JF.conv_flops(h4, w4, 3, 3, 256, 256) * b
    assert rows["fcos"]["flops"] == 4 * JF.conv_flops(h8, w8, 3, 3, 256,
                                                      256) * b
    for family in ("FRCNN", "FCOS"):
        assert rows[family]["flops"] == JF.fpn_flops((H, W), family) * b


def test_profile_steps_writes_a_trace_naming_a_convolution(tmp_path):
    conv = torch.nn.Conv2d(3, 4, 3)
    with profile_steps(str(tmp_path / "trace")) as path:
        conv(torch.randn(1, 3, 16, 16)).sum().backward()
    assert os.path.dirname(path) == str(tmp_path / "trace")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names


def test_write_png_dataset_reuses_only_same_parameters(tmp_path):
    root = str(tmp_path / "d")
    csv_path = synthetic.write_png_dataset(root, 3, (24, 40), seed=2)
    made = list(synthetic.scene_pngs(3, (24, 40), seed=2))
    ds = DrivingDataset(csv_path, root + "/", domain=1)
    assert len(ds) == 3
    for i, (name, img, data, boxes, labels) in enumerate(made):
        got, b, lab, dom = ds[i]
        np.testing.assert_array_equal(got, img)
        want = np.array([[int(v) for v in s.split()]
                         for s in boxes.split(";")], np.float32)
        np.testing.assert_array_equal(b, want)
        np.testing.assert_array_equal(
            lab, [int(v) for v in labels.split(";")])
        assert dom == 1
        with open(os.path.join(root, name), "rb") as f:
            assert f.read() == data
    stamp = os.path.join(root, "img_0000.png")
    before = os.stat(stamp).st_mtime_ns
    assert synthetic.write_png_dataset(root, 3, (24, 40), seed=2) == csv_path
    assert os.stat(stamp).st_mtime_ns == before  # reused
    synthetic.write_png_dataset(root, 2, (24, 40), seed=3)
    assert sorted(n for n in os.listdir(root) if n.endswith(".png")) == [
        "img_0000.png", "img_0001.png"]
    with open(os.path.join(root, "img_0000.png"), "rb") as f:
        assert f.read() == next(synthetic.scene_pngs(2, (24, 40), seed=3))[2]


def test_dense_gt_batch_is_the_jax_eval_scripts_batch():
    assert jax_eval.CANVAS == (608, 1216)
    ref = jax_eval.make_batch(2, seed=3)
    got = synthetic.dense_gt_batch(np.random.RandomState(3), 2, (608, 1216),
                                   domains=False)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
