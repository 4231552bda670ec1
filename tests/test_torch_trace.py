"""The port's spans (`utils/logging.py::span`): with no profiler running a
pair step and a predict enter no `record_function`; under `profile_steps`
the trace of one tiny epoch (a fused pair) and of one predict holds every
`dgod.*` span, each inside the layer it belongs to."""

import contextlib
import json

import pytest
import torch

from _torch_parity import (BLOCKS, CANVAS, MAX_GT, NUM_DOMAINS, REG_WEIGHTS,
                           SMALL, tiny_batch, to_torch)
from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel
from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig
from dgod_tpu_torch.train import steps
from dgod_tpu_torch.train.harness import Trainer
from dgod_tpu_torch.train.optim import OptConfig, init_opt_state
from dgod_tpu_torch.utils import logging as dlog

HALVES = ("dgod.half.m0", "dgod.half.m1")
MODEL = ("dgod.forward", "dgod.predict")
# each span of a (0, 1) pair, a predict of each family, a fetch and the
# loader's wait, with the spans one of which must enclose it
NESTING = {
    "dgod.pair": (), "dgod.predict": (), "dgod.fetch": (),
    "dgod.loader_wait": (),
    "dgod.targets": ("dgod.pair",),
    "dgod.half.m0": ("dgod.pair",), "dgod.half.m1": ("dgod.pair",),
    "dgod.forward": HALVES, "dgod.backward": HALVES, "dgod.update": HALVES,
    "dgod.backbone": MODEL, "dgod.rpn": MODEL, "dgod.roi": MODEL,
    "dgod.box_head": MODEL, "dgod.head": MODEL,
    "dgod.loss": ("dgod.forward",), "dgod.dg_heads": ("dgod.forward",),
    "dgod.postprocess": ("dgod.predict",),
}
PREDICT_KEYS = ("image", "image_size", "scale_back")


@pytest.fixture(scope="module")
def models():
    """A tiny model of each family, on two intra-op threads (the suite runs
    several workers on the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.manual_seed(0)
    kw = dict(num_classes=9, num_domains=NUM_DOMAINS, canvas=CANVAS,
              compute_dtype=torch.float32, backbone_block_counts=BLOCKS,
              device="cpu")
    yield (DGFRCNNModel(config=FRCNNConfig(**SMALL), **kw),
           DGFCOSModel(**kw))
    torch.set_num_threads(threads)


class OneBatch:
    """A train loader of one host batch."""
    dg = False

    def __init__(self, batch):
        self.batch = batch

    def epoch(self):
        yield self.batch


def test_span_enters_no_record_function_without_a_profiler(models,
                                                           monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert dlog.span("dgod.pair") is dlog.span("dgod.predict")
    assert isinstance(dlog.span("dgod.pair"), contextlib.nullcontext)
    frcnn, _ = models
    batch = to_torch(tiny_batch())
    config = OptConfig("sgd", weight_decay=5e-4)
    step = steps.make_pair_step(frcnn, 1, REG_WEIGHTS, config, 1e-3)
    gen = torch.Generator().manual_seed(0)
    _, metrics = step(init_opt_state(dict(frcnn.named_parameters()), config),
                      batch, frcnn.make_draws(2, MAX_GT, gen),
                      frcnn.make_draws(2, MAX_GT, gen, with_rpn=False))
    assert torch.isfinite(metrics["loss"])
    dets = frcnn.predict({k: batch[k] for k in PREDICT_KEYS})
    assert dets["boxes"].shape[0] == 2


def _contains(outer, inner) -> bool:
    return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + 1e-3)


def test_spans_nest_in_the_trace(models, tmp_path):
    frcnn, fcos = models
    host = tiny_batch()
    trainer = Trainer(frcnn, OneBatch(host), None,
                      ckpt_path=str(tmp_path / "t.ckpt"), device="cpu")
    placed = {k: torch.from_numpy(host[k]) for k in PREDICT_KEYS}
    with dlog.profile_steps(str(tmp_path / "trace")) as path:
        trainer.train_epoch()
        trainer._fetch(trainer.eval_step(placed))
        fcos.predict(placed)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("dgod.")]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == set(NESTING)
    for name, parents in NESTING.items():
        for e in by_name[name]:
            assert not parents or any(
                _contains(p, e) for q in parents for p in by_name[q]), name
    # one pair, two halves, each with one forward, backward and update
    assert len(by_name["dgod.pair"]) == 1
    for name in ("dgod.forward", "dgod.backward", "dgod.update"):
        assert len(by_name[name]) == 2
    assert len(by_name["dgod.predict"]) == 2
