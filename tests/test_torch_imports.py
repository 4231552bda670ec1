"""The port stands alone and runs on the card by default.

- `import dgod_tpu_torch` and every submodule leave jax, flax and dgod_tpu
  out of sys.modules, and build no kernel (a subprocess: this test process
  has JAX loaded by tests/conftest.py);
- `dgod_tpu_torch.cli` and the data and checkpoint modules import with
  pandas, cv2, jax, flax and msgpack absent, as on the machine with the
  card (a subprocess that blocks them);
- no file of the port, chip_smoke.py, train_driving_dg_torch.py,
  scripts/check_convergence_torch.py,
  scripts/compare_card_cpu_training.py, scripts/check_multigpu_torch.py,
  scripts/rank_launch.py or tests/_torch_ranks.py (what the gloo ranks of
  the multi-GPU tests run) imports jax, flax, msgpack, pandas or dgod_tpu
  (AST scan; cv2 is imported only where it is installed, and the decode
  that replaces it is tests/test_torch_image_decode.py's);
- an entry point called without `device` on a host without CUDA raises
  instead of running on the CPU;
- chip_smoke.py exits non-zero and prints no result without a card, and
  also when it stands alone in a directory.
"""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dgod_tpu_torch
from dgod_tpu_torch.device import resolve_device
from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dgod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "dgod_tpu")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        dgod_tpu_torch.__path__, "dgod_tpu_torch."))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_leaves_jax_and_dgod_tpu_out():
    mods = _submodules()
    for m in ("ops.cuda_roi_align", "ops.cuda_matchers", "ops.cuda_nms",
              "ops.cuda_proposals", "ops.proposals", "models.fcos",
              "models.dg_fcos", "utils.weights", "utils.logging",
              "utils.flops", "utils.timing", "utils.synthetic", "cli",
              "eval.coco_map", "data.dataset", "data.png", "data.native",
              "data.transforms", "data.loader", "data.jpeg",
              "data.etl.convert", "train.harness", "train.checkpoint",
              "train.flax_msgpack", "parallel.multihost", "parallel.mesh",
              "parallel.spmd", "parallel.tensor_parallel"):
        assert f"dgod_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from dgod_tpu_torch.ops import _build\n"
        "print(json.dumps({'mods': sorted(sys.modules), "
        "'built': sorted(_build._loaded)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in res["mods"]
              if m.split(".")[0] in FORBIDDEN]
    assert leaked == []
    assert res["built"] == []  # kernels build at first launch, not import


def test_cli_imports_without_pandas_cv2_or_jax():
    code = (
        "import sys\n"
        "for name in ('pandas', 'cv2', 'jax', 'jaxlib', 'flax', 'msgpack'):\n"
        "    sys.modules[name] = None  # any import of them raises\n"
        "import dgod_tpu_torch.cli as cli\n"
        "from dgod_tpu_torch.data import dataset, jpeg, loader, png\n"
        "from dgod_tpu_torch.data.etl import convert\n"
        "from dgod_tpu_torch.train import checkpoint, flax_msgpack\n"
        "print(cli.parser_args([]).model)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "FRCNN"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [
        *PKG.rglob("*.py"), REPO / "chip_smoke.py",
        REPO / "train_driving_dg_torch.py",
        REPO / "scripts" / "check_convergence_torch.py",
        REPO / "scripts" / "compare_card_cpu_training.py",
        REPO / "scripts" / "check_multigpu_torch.py",
        REPO / "scripts" / "rank_launch.py",
        REPO / "scripts" / "bench_detail_torch.py",
        REPO / "scripts" / "bench_eval_torch.py",
        REPO / "scripts" / "bench_e2e_torch.py",
        REPO / "scripts" / "roofline_backbone_torch.py",
        REPO / "tests" / "_torch_ranks.py"]))
def test_no_file_of_the_port_imports_jax(path):
    roots = set(_imported_roots(REPO / path))
    assert not roots & set(FORBIDDEN), (path, sorted(roots & set(FORBIDDEN)))


def test_entry_point_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        DGFRCNNModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        DGFCOSModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (REPO, alone):
        out = _run_smoke(cwd)
        assert out.returncode != 0, cwd
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
