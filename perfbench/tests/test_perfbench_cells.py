"""The cells as the driver runs them, at a CPU size: the traffic is the
same for the same seed, the last line keeps its schema, a configuration,
mix and metric added as files alone are run, so is a new architecture with
its builder, reference, FLOP count and kernel, nothing of JAX is loaded,
and a run with the timed path broken reads `correct` false."""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.bench import common, predict, train
from perfbench.bench.common import Spans
from perfbench.tests.tiny import run_tiny, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("name", CELLS)
def test_perfbench_traffic_is_the_seeds(name):
    cell = tiny_cell(name)
    t, c = cell["traffic"], cell["config"]
    if t["kind"] == "train":
        a = train.host_batches(t, c, BIG_SEED)
        b = train.host_batches(t, c, BIG_SEED)
        other = train.host_batches(t, c, BIG_SEED + 1)
        for x, y in zip(a, b):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(a[0]["image"], other[0]["image"])
        d1 = train.draw_maker(c, 2, 32, torch.device("cpu"), BIG_SEED)
        d2 = train.draw_maker(c, 2, 32, torch.device("cpu"), BIG_SEED)
        x, y = d1(True), d2(True)
        assert (x is None) == (y is None) == (c["family"] == "FCOS")
        for u, v in zip(x or (), y or ()):
            assert torch.equal(u, v)
    else:
        s1 = predict.setup(cell, BIG_SEED, torch.device("cpu"), Spans(False))
        s2 = predict.setup(cell, BIG_SEED, torch.device("cpu"), Spans(False))
        np.testing.assert_array_equal(s1.order, s2.order)
        for x, y in zip(s1.requests, s2.requests):
            np.testing.assert_array_equal(x["image"], y["image"])


def _last_line(result, checks):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        common.emit(result, checks)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    tail = err.getvalue().strip().splitlines()
    return line, tail


@pytest.mark.parametrize("name,traced", [(n, False) for n in CELLS]
                         + [("frcnn-predict_b1", True),
                            ("fcos-dg_train", True)])
def test_perfbench_smoke_and_last_line(name, traced):
    result, checks, _ = run_tiny(name, traced=traced)
    line, tail = _last_line(result, checks)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = tiny_cell(name)
    want = [m["name"] for m in (cell["per_layer"] if traced
                                else cell["end_to_end"])]
    assert set(line["metrics"]) <= set(want)
    if not traced:
        assert set(line["metrics"]) == set(want)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count"} <= set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == set(cell["limits"])
    assert tail[-len(checks):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in checks.items()]


def test_perfbench_added_files_run(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as files and entries alone run with no edit to an existing file."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads(
        (ROOT / "perfbench/configs/frcnn_r50_fpn_dg.json").read_text())
    config["name"] = "frcnn_r50_fpn_dg_9dom"
    config["num_domains"] = 4
    (tmp_path / "perfbench/configs/frcnn_r50_fpn_dg_9dom.json").write_text(
        json.dumps(config))
    traffic = json.loads(
        (ROOT / "perfbench/traffic/dg_train.json").read_text())
    traffic.update(generator="synthetic_batch", batches=2)
    (tmp_path / "perfbench/traffic/sparse_train.json").write_text(
        json.dumps(traffic))
    (tmp_path / "perfbench/metrics/pairs_per_cycle.train.py").write_text(
        "def read(ctx):\n    return float(len(ctx.traffic['pairs']))\n")
    (tmp_path / "perfbench/limits/frcnn4-sparse_train.json").write_text(
        json.dumps({"loss_gap": 1e-6}))
    bench["configs"].append(dict(bench["configs"][0],
                                 name="frcnn_r50_fpn_dg_9dom",
                                 file="perfbench/configs/"
                                      "frcnn_r50_fpn_dg_9dom.json"))
    bench["workloads"].append({"name": "frcnn4-sparse_train",
                               "config": "frcnn_r50_fpn_dg_9dom",
                               "traffic": "sparse_train", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("frcnn4-sparse_train")
    bench["per_layer"].append({"name": "pairs_per_cycle.train",
                               "unit": "pairs", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_images_per_s",
                               "workloads": ["frcnn4-sparse_train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell("frcnn4-sparse_train", root=tmp_path)
    assert cell["config"]["num_domains"] == 4
    result, checks, _ = run_tiny("frcnn4-sparse_train", traced=True,
                                 root=tmp_path, cell=cell)
    assert result["metrics"]["pairs_per_cycle.train"]["value"] == 4.0
    assert result["correct"] is True


NEW_ARCH = Path(__file__).resolve().parent / "new_arch"
OLD_CELL = "frcnn-dg_train"
# traced tiny runs from a tree that holds the copy of perfbench first on the
# path (and, for the new architecture, the program's stand-in module): an
# existing cell, then, where the tree has it, the new architecture's
NEW_ARCH_RUN = """
import json, sys, types
sys.path[:0] = [%r, %r]
from perfbench import run
from perfbench.bench import common, kernels, readers, trace, train
from perfbench.tests.tiny import run_tiny

seen, contexts, optimizers = [], [], []
mfu = readers.mfu_percent
readers.mfu_percent = lambda ctx, f: (seen.append(f), mfu(ctx, f))[1]
side_init = train.TrainSide.__init__


def init(self, *a, **k):
    side_init(self, *a, **k)
    optimizers.append(self.opt_config._asdict())


train.TrainSide.__init__ = init
files, asked = common.kernel_files, set()


def kernel_files(ids=None, *a, **k):
    asked.update(ids or ["every file"])
    return files(ids, *a, **k)


common.kernel_files = kernel_files


class Context(run.Context):
    def __init__(self, **kw):
        super().__init__(**kw)
        contexts.append(self)


run.Context = Context
result, checks, _ = run_tiny(%r, traced=True)
ctx = contexts[0]
old = dict(correct=result["correct"], metrics=sorted(result["metrics"]),
           checks=checks, launches=ctx.launches,
           kernel_ids=ctx.profile.kernel_ids,
           loaded=sorted(asked), stand_in="tinyvit_port" in sys.modules)
if "tinyvit-dg_train" not in [w["name"] for w in ctx.cell["bench"][
        "workloads"]]:
    print(json.dumps(dict(old=old)))
    sys.exit(0)
seen.clear()
optimizers.clear()
result, checks, _ = run_tiny("tinyvit-dg_train", traced=True)
ctx = contexts[1]
b = common.builder(ctx.config)
# the roofline of the run's launches over a device trace in which one
# K9 kernel ran for 5 us (the CPU's trace holds no device time)
profile = trace.Profile([
    {"cat": "user_annotation", "name": trace.WINDOW_MARK, "ts": 0,
     "dur": 100},
    {"cat": "kernel", "name": "tiny_attention_kernel<float>", "ts": 10,
     "dur": 5}], 1, ctx.profile.kernel_ids)
roofline = readers.kernel_roofline_percent(
    types.SimpleNamespace(**dict(vars(ctx), profile=profile)))
print(json.dumps(dict(
    old=old, result=result, flops_seen=seen,
    builder_flops=b.train_flops_per_image(ctx.config, ctx.s.batch),
    frcnn_flops=common.builder({"family": "FRCNN"}).train_flops_per_image(
        dict(ctx.config, backbone_block_counts=[1, 1, 1, 1]), ctx.s.batch),
    launches=ctx.launches, roofline=roofline,
    k9_bound_s=kernels.bound_s("K9", "train", ctx.config, ctx.s.batch,
                               ctx.s.max_gt),
    optimizers=optimizers)))
"""


def _run_in(tree: Path) -> dict:
    """NEW_ARCH_RUN in a fresh process from `tree`: its last line."""
    out = subprocess.run(
        [sys.executable, "-c", NEW_ARCH_RUN % (str(tree), str(ROOT),
                                               OLD_CELL)],
        capture_output=True, text=True, timeout=600, cwd=tree)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_perfbench_new_architecture_added_files_run(tmp_path):
    """An architecture the harness has never seen, a plain-ViT backbone
    under DG Faster R-CNN's heads, enters as added files and appended
    entries alone: its builder, reference module, FLOP count, a kernel file
    (K9) whose counter its model raises, a configuration, a cell and its
    limits. A traced tiny run reads `correct` true, takes step_mfu.train
    from the builder's FLOPs and counts K9's launches in
    kernel_roofline.train; no file that was there before changes."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    added = [p.relative_to(NEW_ARCH) for p in sorted(NEW_ARCH.rglob("*"))
             if p.is_file() and "__pycache__" not in p.parts]
    for rel in added:
        assert not (tmp_path / rel).exists(), rel
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(NEW_ARCH / rel, tmp_path / rel)
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = json.loads(json.dumps(old))
    bench["configs"].append({
        "name": "tinyvit_dg", "source": "https://arxiv.org/abs/2203.16527",
        "file": "perfbench/configs/tinyvit_dg.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({"name": "tinyvit-dg_train",
                               "config": "tinyvit_dg", "traffic": "dg_train",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_images_per_s", "step_mfu.train",
                         "kernel_roofline.train"):
            m["workloads"].append("tinyvit-dg_train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    got = _run_in(tmp_path)
    # an existing cell reads in the tree with the new files as it reads
    # without them: the same checks and launch counts, its own kernels'
    # files alone loaded and claiming its kernels' names
    assert got["old"] == _run_in(ROOT)["old"]
    ids = common.cell_kernels(tiny_cell(OLD_CELL)["config"], "train")
    assert got["old"]["kernel_ids"] == list(ids)
    assert sorted(got["old"]["launches"]) == list(ids)
    assert got["old"]["loaded"] == list(ids)
    assert got["old"]["stand_in"] is False
    assert got["old"]["correct"] is True
    # the builders' and kernel files' tests hold in the tree with K9
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "perfbench/tests/test_perfbench_builders.py"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(tmp_path), str(ROOT)])))
    assert tests.returncode == 0, tests.stdout[-3000:]
    assert " passed" in tests.stdout and "failed" not in tests.stdout
    result = got["result"]
    assert result["correct"] is True, result
    # kernel_roofline.train reads nothing: the CPU's trace holds no device
    # time; it is read below over a device trace of K9
    assert set(result["metrics"]) == {"step_mfu.train"}
    assert got["flops_seen"] == [got["builder_flops"]]
    assert got["builder_flops"] != got["frcnn_flops"]
    assert result["metrics"]["step_mfu.train"]["value"] > 0
    assert got["launches"]["K9"] > 0
    assert got["roofline"] == pytest.approx(
        100.0 * got["launches"]["K9"] * got["k9_bound_s"] / 5e-6)
    # the optimizer object passed whole: the program's side and the
    # reference's take the configuration's b2
    assert [o["kind"] for o in got["optimizers"]] == ["adam", "adam"]
    assert [o["b2"] for o in got["optimizers"]] == [0.99, 0.99]
    # no file that was there changed; BENCHMARK.json only gained entries
    after = _digests(tmp_path)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}, changed
    for key, value in old.items():
        if not isinstance(value, list):
            assert bench[key] == value
            continue
        for a, b in zip(value, bench[key]):
            if isinstance(a, dict):  # entries kept; `workloads` appended to
                a, b = dict(a), dict(b)
                head = b.pop("workloads", [])[:len(a.get("workloads", []))]
                assert head == a.pop("workloads", [])
            assert a == b


def test_perfbench_forbidden_names_compare_whole():
    held = {"dgod_tpu_torch": 1, "dgod_tpu_torch.ops": 1, "jaxtyping": 1,
            "dgod_tpu": 1, "dgod_tpu.models.x": 1, "jax": 1, "jaxlib.xla": 1,
            "flax.linen": 1, "optax": 1, "perfbench": 1}
    assert common.forbidden_modules(held) == [
        "dgod_tpu", "dgod_tpu.models.x", "flax.linen", "jax", "jaxlib.xla",
        "optax"]


def test_perfbench_loads_no_jax():
    """A whole tiny run of each mix and the reference, in a fresh process:
    no module of JAX or of the JAX package is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.run, perfbench.control\n"
        "import perfbench.reference.models.dg_frcnn\n"
        "import perfbench.reference.models.dg_fcos\n"
        "import perfbench.reference.train.steps\n"
        "from perfbench.tests.tiny import run_tiny\n"
        "for n in ('frcnn-predict_b1', 'fcos-dg_train'):\n"
        "    run_tiny(n, seconds=0.05)\n"
        "from perfbench.bench import common\n"
        "print(common.forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_perfbench_without_a_card_prints_nothing():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", str(BIG_SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


# -- the timed path broken underneath: `correct` must read false ----------

def _unchanged_state(monkeypatch):
    from dgod_tpu_torch.train import steps

    monkeypatch.setattr(steps, "apply_updates",
                        lambda params, grads, opt_state, *a, **k: opt_state)


def _half_batch(monkeypatch):
    from dgod_tpu_torch.models import dg_fcos, dg_frcnn

    for cls in (dg_frcnn.DGFRCNNModel, dg_fcos.DGFCOSModel):
        loss = cls.loss_for_mode

        def half(self, batch, draws, mode, reg, *a, _loss=loss, **k):
            n = batch["image"].shape[0] // 2
            batch = {key: v[:n] for key, v in batch.items()}
            if draws is not None:
                draws = type(draws)(*(None if d is None else d[:n]
                                      for d in draws))
            k = {key: v[:n] for key, v in k.items()}
            return _loss(self, batch, draws, mode, reg, *a, **k)

        monkeypatch.setattr(cls, "loss_for_mode", half)


def _altered_answer(monkeypatch):
    from dgod_tpu_torch.models import faster_rcnn

    post = faster_rcnn.FRCNNDetector.postprocess

    def altered(self, *a, **k):
        out = dict(post(self, *a, **k))
        out["scores"] = out["scores"] * 0.5
        out["boxes"] = out["boxes"] + 16.0
        return out

    monkeypatch.setattr(faster_rcnn.FRCNNDetector, "postprocess", altered)


def _empty_answer(monkeypatch):
    from dgod_tpu_torch.models import faster_rcnn

    post = faster_rcnn.FRCNNDetector.postprocess

    def empty(self, *a, **k):
        out = dict(post(self, *a, **k))
        out["valid"] = torch.zeros_like(out["valid"])
        return out

    monkeypatch.setattr(faster_rcnn.FRCNNDetector, "postprocess", empty)


def _k5_shifted(monkeypatch):
    """The RPN's proposals (K5's decode) moved by 4 pixels."""
    from dgod_tpu_torch.models import faster_rcnn

    decode_nms = faster_rcnn.decode_nms

    def shifted(*a, **k):
        boxes, keep = decode_nms(*a, **k)
        return boxes + torch.tensor([4.0, 0.0, 4.0, 0.0]), keep

    monkeypatch.setattr(faster_rcnn, "decode_nms", shifted)


def _k6_keeps_overlaps(monkeypatch):
    """K6's first-k picks with no suppression."""
    from dgod_tpu_torch.ops import nms

    topk = nms.nms_topk
    monkeypatch.setattr(nms, "nms_topk", lambda boxes, scores, valid, iou,
                        k: topk(boxes, scores, valid, 1.0, k))


def _k6_last_picks(monkeypatch):
    """K6 picking the lowest-scoring candidates first."""
    from dgod_tpu_torch.ops import nms

    topk = nms.nms_topk

    def last(boxes, scores, valid, iou, k):
        idx, ok, _ = topk(boxes, -scores, valid, iou, k)
        return idx, ok, torch.gather(scores, 1, idx)

    monkeypatch.setattr(nms, "nms_topk", last)


FAULTS = [(n, f) for n in CELLS if "train" in n
          for f in (_unchanged_state, _half_batch)]
FAULTS += [(n, f) for n in CELLS if "predict" in n
           for f in (_altered_answer, _empty_answer, _k5_shifted,
                     _k6_keeps_overlaps, _k6_last_picks)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_perfbench_broken_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    cell = tiny_cell(name)
    if cell["traffic"]["kind"] == "train":
        cell["traffic"]["batch"] = 4
    result, checks, _ = run_tiny(name, cell=cell)
    assert result["correct"] is False, checks
    if fault in (_empty_answer, _k5_shifted, _k6_keeps_overlaps,
                 _k6_last_picks):
        # what the scores alone cannot see: the set is judged too
        assert checks["rescore_gap"]["value"] <= \
            checks["rescore_gap"]["limit"], checks
