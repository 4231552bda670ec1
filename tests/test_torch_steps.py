"""The port's one train-step layer (`dgod_tpu_torch/train/steps.py`), for
one card and for a mesh:

- a pair step built with a one-rank `Mesh` and no process group leaves the
  parameters, the Adam state and the metrics bit for bit as one built
  without a mesh (the data group's reduction of one rank sums one part and
  divides by one), and so does a single-mode train step;
- once built, a pair step walks no module tree: each mode's active set,
  parameters and `requires_grad` settings were decided by the factory;
- the Trainer builds its steps after the model's parameters are final (a
  parameter rebound where `shard_model` runs is the one the step updates);
- `parallel/` imports nothing from `train/` (AST scan): the arrow points
  from the steps to the mesh's reductions, one way.

Tiny models (64x128 canvas, backbone blocks (1,1,1,1), float32) on one
intra-op thread; tests/test_torch_parallel.py runs the mesh path on 2 and
4 gloo ranks, tensor parallelism included.
"""

import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from dgod_tpu_torch.models.dg_frcnn import batch_to_torch
from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig
from dgod_tpu_torch.parallel.mesh import Mesh
from dgod_tpu_torch.train import harness
from dgod_tpu_torch.train import steps as S
from dgod_tpu_torch.train.optim import init_opt_state
from dgod_tpu_torch.utils.synthetic import (REG_WEIGHTS, HostBatches,
                                            synthetic_model)

PKG = Path(__file__).resolve().parents[1] / "dgod_tpu_torch"
SMALL_FRCNN = FRCNNConfig(rpn_pre_nms_train=256, rpn_pre_nms_test=32,
                          rpn_post_nms_train=256, rpn_post_nms_test=32,
                          rpn_batch_per_image=64, box_batch_per_image=64)


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(family: str):
    """(model, host batches) of `family` at the tests' size."""
    config = SMALL_FRCNN if family == "FRCNN" else None
    return synthetic_model(family, "cpu", canvas=(64, 128), batch=2,
                           num_domains=2, block_counts=(1, 1, 1, 1),
                           compute_dtype=torch.float32, config=config)


def draws(model, batch, seed=0):
    gen = torch.Generator().manual_seed(seed)
    g = batch["boxes"].shape[1]
    return (model.make_draws(2, g, gen, with_rpn=True),
            model.make_draws(2, g, gen, with_rpn=False))


def run(model, host, mesh, kind):
    """One (0,1) pair, or one mode-1 train step, built with `mesh`.
    -> (parameters, optimizer state, metrics)."""
    opt_config, lr = S.make_optimizer(model.name)
    state = init_opt_state(dict(model.named_parameters()), opt_config)
    batch = batch_to_torch(host, "cpu")
    d0, d1 = draws(model, batch)
    if kind == "pair":
        step = S.make_pair_step(model, 1, REG_WEIGHTS, opt_config, lr,
                                mesh=mesh)
        state, metrics = step(state, batch, d0, d1)
    else:
        step = S.make_train_step(model, 1, REG_WEIGHTS, opt_config, lr,
                                 mesh=mesh)
        state, metrics = step(state, batch, d1)
    return dict(model.named_parameters()), state, metrics


def same_bits(a, b) -> bool:
    """Tensors, dicts and ints equal bit for bit, keys in the same order."""
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(same_bits(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.detach().reshape(-1).view(torch.uint8),
                                b.detach().reshape(-1).view(torch.uint8)))
    return a == b


@pytest.mark.parametrize("kind", ["pair", "train"])
def test_one_rank_mesh_step_is_the_plain_step(one_thread, kind):
    model, (host,) = tiny("FCOS")
    twin = copy.deepcopy(model)
    plain = run(model, host, None, kind)
    meshed = run(twin, host, Mesh(1), kind)
    assert S.make_optimizer("FCOS")[0].kind == "adam"
    for got, want in zip(meshed, plain):
        assert same_bits(got, want)
    # the step moved the parameters: the comparison is not of two inits
    init, _ = tiny("FCOS")
    assert not same_bits(plain[0], dict(init.named_parameters()))


@pytest.mark.parametrize("meshed", [False, True], ids=["card", "mesh"])
@pytest.mark.parametrize("family", ["FRCNN", "FCOS"])
def test_pair_step_walks_no_module_tree(one_thread, family, meshed,
                                        monkeypatch):
    model, (host,) = tiny(family)
    opt_config, lr = S.make_optimizer(family)
    state = init_opt_state(dict(model.named_parameters()), opt_config)
    step = S.make_pair_step(model, 3, REG_WEIGHTS, opt_config, lr,
                            mesh=Mesh(1) if meshed else None)
    batch = batch_to_torch(host, "cpu")
    d0, dk = draws(model, batch)
    walks = []
    for name in ("named_parameters", "named_modules"):
        method = getattr(torch.nn.Module, name)

        def counted(self, *args, _method=method, _name=name, **kwargs):
            walks.append(_name)
            return _method(self, *args, **kwargs)

        monkeypatch.setattr(torch.nn.Module, name, counted)
    _, metrics = step(state, batch, d0, dk)
    _, metrics = step(state, batch, d0, dk)
    monkeypatch.undo()
    assert walks == []
    assert np.isfinite(float(metrics["loss"]))
    # each half left requires_grad as its mode set it: mode 3 last
    active = S.build_active_mask(model.param_group_labels(), 3)
    for n, p in model.named_parameters():
        assert p.requires_grad == active[n], n


def test_trainer_builds_its_steps_after_sharding(one_thread, monkeypatch,
                                                 tmp_path):
    """A parameter that `shard_model` rebinds (here one detector leaf,
    replaced by an equal new Parameter on a one-rank mesh) is the one the
    Trainer's pair steps update."""
    model, host = tiny("FCOS")
    name = next(n for n, lbl in model.param_group_labels().items()
                if lbl == "detector")
    path, leaf = name.rsplit(".", 1)
    rebound = []

    def shard_model(m, mesh):
        layer = m.get_submodule(path)
        p = getattr(layer, leaf)
        setattr(layer, leaf, torch.nn.Parameter(p.detach().clone()))
        rebound.append((p, getattr(layer, leaf)))
        return {}

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(harness, "shard_model", shard_model)
    t = harness.Trainer(model, HostBatches(host, True), None, dg=True,
                        device="cpu", mesh=Mesh(1), log_every=10 ** 9,
                        ckpt_path=str(tmp_path / "t.ckpt"))
    (old, new), = rebound
    before = new.detach().clone()
    t.train_epoch()
    assert torch.equal(old.detach(), before)  # the stale one stays put
    assert not torch.equal(new.detach(), before)


def _train_imports(path: Path):
    """The `dgod_tpu_torch.train` modules that `path`, a module under
    dgod_tpu_torch/parallel/, imports (absolute or relative)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                # parallel/x.py: level 1 is parallel/, level 2 the package
                parts = ["dgod_tpu_torch", "parallel"][:3 - node.level]
                base = ".".join(parts + ([base] if base else []))
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        yield from (n for n in names
                    if n == "dgod_tpu_torch.train"
                    or n.startswith("dgod_tpu_torch.train."))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG)) for p in (PKG / "parallel").rglob("*.py")))
def test_parallel_imports_nothing_from_train(path):
    assert list(_train_imports(PKG / path)) == [], path


def test_the_scan_sees_an_import_from_train(tmp_path):
    """The scan above finds each form of the import it forbids."""
    for line in ("from ..train.steps import _half",
                 "from .. import train",
                 "import dgod_tpu_torch.train.optim",
                 "from dgod_tpu_torch.train import steps"):
        path = tmp_path / "spmd.py"
        path.write_text(line + "\n")
        assert list(_train_imports(path)), line
    path.write_text("from ..models.layers import Conv\nfrom . import mesh\n")
    assert list(_train_imports(path)) == []
