"""The eval step's CUDA graphs (`train/eval_graphs.py`, behind
`train/steps.py::make_eval_step`).

On the CPU the step is the model's eager predict. The graph logic runs
here on a toy model with `CudaGraph` replaced by a stand-in whose capture
runs the predict once and whose replay runs it again into the captured
outputs, and `on_card` accepting CPU tensors: the order of eager call,
capture and replay per signature, the cap on held graphs, the fallbacks
(a capture that raises, tensor-parallel layers), rebinding and the
kernel-counter arithmetic.

The tests marked `card` run on an H100 (and skip without a CUDA device):

    python3 -m pytest tests/test_torch_eval_graph.py --noconftest -m card -q

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine does not have; this file imports none of it.)
"""

import warnings

import numpy as np
import pytest
import torch
from torch import nn

from dgod_tpu_torch.models.layers import Dense
from dgod_tpu_torch.ops import cuda_nms, cuda_proposals
from dgod_tpu_torch.parallel.mesh import Mesh
from dgod_tpu_torch.parallel.tensor_parallel import shard_model
from dgod_tpu_torch.train import eval_graphs as EG
from dgod_tpu_torch.train import steps
from dgod_tpu_torch.utils import synthetic
from dgod_tpu_torch.utils.logging import span

PREDICT_KEYS = ("image", "image_size", "scale_back")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def counters():
    return (EG.graph_captures, EG.graph_replays, EG.graph_eager_calls)


def moved(before):
    """(captures, replays, eager calls) since `before` (counters())."""
    return tuple(a - b for a, b in zip(counters(), before))


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# -- the CPU: the eager predict ---------------------------------------------


@pytest.fixture(scope="module")
def frcnn_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    model, host = synthetic.sized_model("FRCNN", "cpu",
                                        synthetic.SIZES["cpu"])
    yield model, {k: torch.from_numpy(host[0][k]) for k in PREDICT_KEYS}
    torch.set_num_threads(threads)


def span_names(fn) -> list:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(e.name for e in prof.events()
                  if e.name.startswith("dgod."))


def test_eval_step_on_cpu_is_the_eager_predict(frcnn_cpu):
    model, batch = frcnn_cpu
    step = steps.make_eval_step(model)
    with torch.no_grad():
        want = model.predict(batch)
    before = counters()
    for _ in range(3):
        assert same(step(batch), want)
    assert moved(before) == (0, 0, 3)
    assert span_names(lambda: step(batch)) == span_names(
        lambda: model.predict(batch))
    assert "dgod.predict" in span_names(lambda: step(batch))


# -- the graph logic on a stand-in --------------------------------------------


class Toy(nn.Module):
    """A predict that counts kernel launches as the port's wrappers do:
    one K6 and two K5 a call."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.tensor([1.0, 2.0, 3.0]))
        self.register_buffer("b", torch.tensor([0.5, 0.0, -0.5]))
        self.calls = 0

    def predict(self, batch):
        self.calls += 1
        cuda_nms.launches += 1
        cuda_proposals.launches += 2
        with span("dgod.predict"):
            x = batch["image"].float().sum(-1, keepdim=True)
            return {"boxes": x * self.w + self.b,
                    "scores": (x * self.w).sum(-1)}


class FakeGraph:
    """Stands in for eval_graphs.CudaGraph: capture runs the predict once,
    as a capture runs the wrappers' Python; a replay runs it again on the
    captured inputs, writes into the captured outputs and, as a real
    replay, runs no Python of the wrappers (their counters stay)."""
    made = []
    fail = None  # an exception capture raises

    def __init__(self, stream):
        self.stream = stream
        FakeGraph.made.append(self)

    @staticmethod
    def side_stream(device):
        return ("stream", device)

    def capture(self, fn, batch):
        self.fn, self.batch = fn, batch
        out = fn(batch)
        if FakeGraph.fail is not None:
            raise FakeGraph.fail
        self.out = out
        return out

    def replay(self):
        counts = EG.kernel_counts()
        fresh = self.fn(self.batch)
        EG._add_counts([a - b for a, b in zip(counts, EG.kernel_counts())])
        for k, v in self.out.items():
            v.copy_(fresh[k])


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(EG, "CudaGraph", FakeGraph)
    monkeypatch.setattr(EG, "on_card", lambda batch: True)
    monkeypatch.setattr(FakeGraph, "made", [])
    monkeypatch.setattr(FakeGraph, "fail", None)
    return FakeGraph


def image(seed: int, shape=(1, 4, 6, 3)) -> dict:
    rng = np.random.RandomState(seed)
    return {"image": torch.from_numpy(
        rng.randint(0, 255, shape).astype(np.uint8)),
        "image_size": torch.tensor([[4.0, 6.0]] * shape[0])}


def test_eager_then_capture_then_replay(fake):
    model = Toy()
    step = steps.make_eval_step(model)
    before = counters()
    first = step(image(0))
    assert moved(before) == (0, 0, 1) and not fake.made
    sent = image(1)
    second = step(sent)
    assert moved(before) == (1, 1, 1) and len(fake.made) == 1
    # the capturing call: the capture, then the replay
    assert model.calls == 3
    third = step(image(2))
    assert moved(before) == (1, 2, 1) and len(fake.made) == 1
    for got, seed in ((first, 0), (second, 1), (third, 2)):
        assert same(got, model.predict(image(seed)))
    # the graph's inputs are its own: the caller's batch is not kept
    assert fake.made[0].batch["image"] is not sent["image"]


def test_returned_tensors_are_not_aliased(fake):
    model = Toy()
    step = steps.make_eval_step(model)
    step(image(0))
    a = step(image(1))
    kept = {k: v.clone() for k, v in a.items()}
    b = step(image(2))
    assert same(a, kept) and not same(a, b)
    assert not any(a[k] is fake.made[0].out[k] for k in a)


def test_signatures_key_shape_dtype_and_values(fake):
    model = Toy()
    step = steps.make_eval_step(model)
    batches = [image(0), image(0, (2, 4, 6, 3)),
               dict(image(0), image_size=image(0)["image_size"].double()),
               dict(image(0), num_real=1)]
    for b in batches:
        step(b)
    assert not fake.made  # each signature's first call is eager
    for b in batches:
        step(b)
    assert len(fake.made) == 4
    # a value that cannot be hashed: no signature, never captured
    before = counters()
    for _ in range(3):
        step(dict(image(0), meta=[1]))
    assert moved(before) == (0, 0, 3) and len(fake.made) == 4
    assert EG.signature(dict(image(0), meta=[1])) is None
    assert EG.signature(image(0)) == EG.signature(image(3))
    assert EG.signature(image(0)) != EG.signature(dict(image(0), num_real=1))


def test_at_most_max_graphs_signatures_hold_a_graph(fake):
    model = Toy()
    graphs = EG.EvalGraphs(model)
    shapes = [(n, 4, 6, 3) for n in range(1, EG.MAX_GRAPHS + 2)]
    for _ in range(2):
        for s in shapes:
            graphs(image(0, s))
    assert len(graphs.graphs) == EG.MAX_GRAPHS == len(fake.made)
    extra = image(5, shapes[-1])
    before = counters()
    assert same(graphs(extra), model.predict(extra))
    assert moved(before) == (0, 0, 1)
    assert EG.signature(extra) not in graphs.graphs


def test_a_capture_that_raises_stays_eager(fake):
    model = Toy()
    step = steps.make_eval_step(model)
    fake.fail = RuntimeError("operation not permitted when stream is "
                             "capturing")
    kernels = EG.kernel_counts()
    before = counters()
    step(image(0))
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        got = step(image(1))
    # what ran: two eager calls; the capture's own counting was taken back
    assert cuda_nms.launches - kernels[5] == 2
    assert same(got, model.predict(image(1)))
    assert moved(before) == (0, 0, 2) and len(fake.made) == 1
    fake.fail = None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for seed in (2, 3):
            assert same(step(image(seed)), model.predict(image(seed)))
    assert moved(before) == (0, 0, 4) and len(fake.made) == 1


def test_tensor_parallel_layers_never_capture(fake, monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    model = Toy()
    model.box_head = nn.Module()
    model.box_head.fc6 = Dense(3, 4)
    assert shard_model(model, Mesh(1, 2))  # the predict never calls fc6
    step = steps.make_eval_step(model)
    before = counters()
    for seed in range(3):
        assert same(step(image(seed)), model.predict(image(seed)))
    assert moved(before) == (0, 0, 3) and not fake.made


def test_kernel_counters_under_capture_and_replay(fake):
    model = Toy()
    graphs = EG.EvalGraphs(model)
    k0 = EG.kernel_counts()
    graphs(image(0))  # eager: one K6, two K5
    graphs(image(1))  # capture (taken back), first replay
    k1 = EG.kernel_counts()
    # two predicts ran on the device: the eager call and the replay
    assert (k1[5] - k0[5], k1[4] - k0[4]) == (2, 4)
    assert k1[:4] == k0[:4]
    # what one replay adds: (K1, K2, K3, K4, K5, K6, K7, K8)
    assert [r.launches for r in graphs.graphs.values()] == [
        [0, 0, 0, 0, 2, 1, 0, 0]]
    for _ in range(4):
        graphs(image(2))
    k2 = EG.kernel_counts()
    assert (k2[5] - k1[5], k2[4] - k1[4]) == (4, 8)
    assert k2[:4] == k0[:4]


def test_a_rebound_parameter_is_captured_again(fake):
    model = Toy()
    step = steps.make_eval_step(model)
    step(image(0))
    step(image(1))
    before = counters()
    with torch.no_grad():
        model.w.mul_(2.0)  # in place, as the optimizer updates
    assert same(step(image(2)), model.predict(image(2)))
    assert moved(before) == (0, 1, 0) and len(fake.made) == 1
    model.w = nn.Parameter(model.w.detach().clone())  # rebound
    step(image(2))
    assert moved(before) == (1, 2, 0) and len(fake.made) == 2
    model.b.data = model.b.clone()  # a buffer moved to another address
    step(image(3))
    assert moved(before) == (2, 3, 0) and len(fake.made) == 3
    step(image(3))
    assert moved(before) == (2, 4, 0) and len(fake.made) == 3


# -- the card ----------------------------------------------------------------


def card_frcnn(device, batch):
    model, host = synthetic.synthetic_model("FRCNN", device, batch=batch,
                                            n_batches=2)
    return model, [{k: torch.from_numpy(h[k]).to(device)
                    for k in PREDICT_KEYS} for h in host]


def eager(model, batch):
    with torch.no_grad():
        return model.predict(batch)


@pytest.mark.card
def test_card_replay_equals_eager_bitwise(card):
    model, (b0, b1) = card_frcnn(card, 8)
    step = steps.make_eval_step(model)
    kernels, before = EG.kernel_counts(), counters()
    singles = [{k: v[i:i + 1] for k, v in b0.items()} for i in range(4)]
    # batch 1: eager, capture, then replays of other images
    for one in singles:
        assert same(step(one), eager(model, one))
    assert moved(before) == (1, 3, 1)
    # K1, K5 and K6 counted once a replay, as an eager predict counts them
    ran = [a - b for a, b in zip(EG.kernel_counts(), kernels)]
    per = EG.kernel_counts()
    step(singles[0])
    one = [a - b for a, b in zip(EG.kernel_counts(), per)]
    assert one[0] >= 1 and one[4] >= 1 and one[5] >= 1, one
    assert all(r % o == 0 for r, o in zip(ran, one) if o), (ran, one)
    # batch 8, then a ragged last batch of 3 and a padded tail
    tail = {k: v[:3] for k, v in b1.items()}
    padded = dict(b1, num_real=5)
    for b in (b0, b1, b0, tail, tail, tail, padded, padded, padded):
        assert same(step(b), eager(model, {k: b[k] for k in PREDICT_KEYS}))
    assert EG.graph_captures - before[0] == 4


@pytest.mark.card
def test_card_replay_sees_weights_updated_in_place(card):
    from dgod_tpu_torch.train.optim import (OptConfig, apply_updates,
                                            init_opt_state)

    model, (b0, _) = card_frcnn(card, 1)
    step = steps.make_eval_step(model)
    step(b0)
    first = step(b0)
    params = dict(model.named_parameters())
    config = OptConfig("sgd", weight_decay=5e-4)
    gen = torch.Generator(device=card).manual_seed(0)
    grads = {n: torch.randn(p.shape, generator=gen, device=card) * 0.05
             for n, p in params.items()}
    apply_updates(params, grads, init_opt_state(params, config),
                  {n: True for n in params}, 2e-3, config)
    before = counters()
    got = step(b0)
    assert moved(before) == (0, 1, 0)
    assert same(got, eager(model, b0)) and not same(got, first)


@pytest.mark.card
def test_card_rebound_state_is_captured_again(card):
    model, (b0, b1) = card_frcnn(card, 1)
    step = steps.make_eval_step(model)
    step(b0)
    step(b0)
    state = {k: v.clone() * (1.01 if v.is_floating_point() else 1)
             for k, v in model.state_dict().items()}
    model.load_state_dict(state, assign=True)
    before = counters()
    got = step(b1)
    assert moved(before) == (1, 1, 0)
    assert same(got, eager(model, b1))


@pytest.mark.card
def test_card_returned_tensors_are_not_aliased(card):
    model, (b0, b1) = card_frcnn(card, 1)
    step = steps.make_eval_step(model)
    step(b0)
    a = step(b0)
    kept = {k: v.clone() for k, v in a.items()}
    step(b1)
    torch.cuda.synchronize(card)
    assert same(a, kept)


@pytest.mark.card
def test_card_fcos_falls_back_to_its_eager_answer(card):
    model, host = synthetic.synthetic_model("FCOS", card, batch=1)
    b = {k: torch.from_numpy(host[0][k]).to(card) for k in PREDICT_KEYS}
    step = steps.make_eval_step(model)
    before = counters()
    assert same(step(b), eager(model, b))
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        assert same(step(b), eager(model, b))
    assert same(step(b), eager(model, b))
    assert moved(before) == (0, 0, 3)
