"""The optimizer's update (`train/optim.py`) and the wrapper of K9, its
one-pass multi-tensor kernel (`ops/cuda_optim.py`,
`csrc/multi_tensor_update.cu`).

On the CPU: the table the wrapper hands the kernel (`cuda_optim.tables`, a
pure function of the leaves: launches at the capacity, offsets, null
gradient pointers, strides of a channels_last gradient read as the kernel
reads them, bias corrections rounded as ATen rounds them on the card), the
leaves of an update, the plain loop that the CPU runs, the counters that
`update_fused_share.train` reads, and the kernel's names against the
benchmark's patterns.

The tests marked `card` hold K9 to the plain loop bit for bit on an H100
(and skip without a CUDA device):

    python3 -m pytest tests/test_torch_optim_update.py --noconftest -m card -q

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine does not have; this file imports none of it.)
"""

import importlib.util
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dgod_tpu_torch.ops import cuda_optim
from dgod_tpu_torch.train import optim
from dgod_tpu_torch.train.optim import Leaf, OptConfig

ROOT = Path(__file__).resolve().parents[1]
ADAM = OptConfig("adam", weight_decay=1e-4)
SGD = OptConfig("sgd", weight_decay=5e-4)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def adam_leaf(shape, count=1, grad=True, gen=None):
    gen = gen or torch.Generator().manual_seed(0)
    p = torch.randn(shape, generator=gen)
    g = torch.randn(shape, generator=gen) if grad else None
    return Leaf(p, g, torch.zeros_like(p), torch.zeros_like(p), count)


def old_loop(params, grads, opt_state, active, lr, config):
    """The update as the port wrote it before K9, leaf by leaf."""
    for name, p in params.items():
        if not active[name]:
            continue
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        if config.kind == "sgd":
            p.copy_(p - lr * (g + config.weight_decay * p))
            continue
        g = g + config.weight_decay * p
        c = opt_state["count"][name] + 1
        opt_state["count"][name] = c
        m = opt_state["mu"][name]
        v = opt_state["nu"][name]
        m.copy_(config.b1 * m + (1 - config.b1) * g)
        v.copy_(config.b2 * v + (1 - config.b2) * (g * g))
        m_hat = m / (1 - config.b1 ** c)
        v_hat = v / (1 - config.b2 ** c)
        p.copy_(p - lr * m_hat / (torch.sqrt(v_hat) + config.eps))
    return opt_state


# -- the table ----------------------------------------------------------------


@pytest.mark.parametrize("capacity", [1, 3, 7, 10, 384])
def test_k9_tables_split_at_capacity(capacity):
    leaves = [adam_leaf((3, 5), count=i + 1) for i in range(10)]
    tables = cuda_optim.tables(leaves, ADAM, capacity)
    assert [len(t.numel) for t in tables] == \
        [min(capacity, 10 - i) for i in range(0, 10, capacity)]
    assert all(len(t.numel) <= capacity for t in tables)
    # every leaf once, in order
    got = np.concatenate([t.ptrs for t in tables])
    want = [[leaf.p.data_ptr(), leaf.m.data_ptr(), leaf.v.data_ptr(),
             leaf.g.data_ptr()] for leaf in leaves]
    assert got.tolist() == want


def test_k9_tables_offsets_are_padded_cumulative_counts():
    sizes = [(5,), (2, 4), (1,), (0, 3), (3, 4), (7, 1, 1)]
    leaves = [adam_leaf(s) for s in sizes]
    (t,) = cuda_optim.tables(leaves, ADAM, 384)
    # the empty leaf is left out; each leaf rounded up to 4 on the line
    assert t.numel.tolist() == [5, 8, 1, 12, 7]
    assert t.start.tolist() == [0, 8, 16, 20, 32, 40]
    assert t.start.dtype == np.int64 and t.numel.dtype == np.int32
    assert all(s % 4 == 0 for s in t.start)


def test_k9_tables_null_pointer_for_none_gradient():
    leaves = [adam_leaf((8,), grad=False), adam_leaf((8,))]
    (t,) = cuda_optim.tables(leaves, ADAM, 384)
    assert t.ptrs[0, 3] == 0 and t.ptrs[1, 3] == leaves[1].g.data_ptr()
    assert t.gsize[0].tolist() == [1, 1, 1]
    assert t.gstride[0].tolist() == [0, 0, 0, 0]
    # SGD holds no moments: their pointers are null too
    (s,) = cuda_optim.tables([Leaf(leaves[1].p, leaves[1].g, None, None, 0)],
                             SGD, 384)
    assert s.ptrs[0].tolist() == [leaves[1].p.data_ptr(), 0, 0,
                                  leaves[1].g.data_ptr()]
    assert s.rc.tolist() == [[0.0, 0.0]]


def kernel_offsets(t, row: int, numel: int) -> np.ndarray:
    """The gradient's element offsets as the kernel computes them from the
    row's sizes and strides, for linear indices 0..numel-1."""
    s1, s2, s3 = (int(x) for x in t.gsize[row])
    t0, t1, t2, t3 = (int(x) for x in t.gstride[row])
    j = np.arange(numel)
    i3, k = j % s3, j // s3
    i2, k = k % s2, k // s2
    i1, i0 = k % s1, k // s1
    return i0 * t0 + i1 * t1 + i2 * t2 + i3 * t3


@pytest.mark.parametrize("shape, make", [
    ((6, 8, 3, 3), lambda x: x.contiguous(memory_format=torch.channels_last)),
    ((6, 8, 3, 3), lambda x: x.permute(1, 0, 2, 3).contiguous()
     .permute(1, 0, 2, 3)),
    ((5, 6, 7), lambda x: x.transpose(0, 2).contiguous().transpose(0, 2)),
    ((6, 72), lambda x: x.t().contiguous().t()),
    ((6, 8), lambda x: torch.randn(6, 16)[:, ::2]),  # not dense
], ids=["channels_last", "permuted", "3d", "transposed", "sliced"])
def test_k9_tables_read_strided_gradient_in_place(shape, make):
    p = torch.randn(shape)
    g = make(torch.randn(shape))
    assert g.shape == p.shape and not g.is_contiguous()
    leaf = Leaf(p, g, torch.zeros_like(p), torch.zeros_like(p), 1)
    (t,) = cuda_optim.tables([leaf], ADAM, 384)
    assert t.flags[0] == cuda_optim.STRIDED
    pad = 4 - g.dim()
    assert t.gstride[0].tolist() == [0] * pad + list(g.stride())
    assert t.gsize[0].tolist() == ([1] * pad + list(g.shape))[1:]
    storage = torch.as_strided(g, (g.untyped_storage().nbytes() // 4,), (1,),
                               0)
    off = kernel_offsets(t, 0, g.numel()) + g.storage_offset()
    assert torch.equal(storage[torch.from_numpy(off)], g.reshape(-1))


def test_k9_tables_channels_last_gradient_of_contiguous_weight():
    p = torch.randn(4, 6, 3, 3)
    g = torch.randn(p.shape).contiguous(memory_format=torch.channels_last)
    (t,) = cuda_optim.tables(
        [Leaf(p, g, torch.zeros_like(p), torch.zeros_like(p), 1)], ADAM, 384)
    assert t.gsize[0].tolist() == [6, 3, 3]
    assert t.gstride[0].tolist() == [54, 1, 18, 6]
    assert t.flags[0] == cuda_optim.STRIDED


def test_k9_tables_vectorise_only_aligned_contiguous_leaves():
    p = torch.randn(16)
    flat = torch.randn(40)
    aligned = flat[:16] if flat.data_ptr() % 16 == 0 else None
    misaligned = flat[1:17]
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    rows = [Leaf(p, misaligned, m, v, 1), Leaf(p, None, m, v, 1)]
    if aligned is not None:
        rows.append(Leaf(p, aligned, m, v, 1))
    (t,) = cuda_optim.tables(rows, ADAM, 384)
    assert p.data_ptr() % 16 == 0  # the CPU allocator aligns as the card's
    assert t.flags.tolist() == [0] + [cuda_optim.VEC] * (len(rows) - 1)


def test_k9_tables_round_scalars_and_bias_corrections_as_aten():
    counts = [1, 2, 3, 7, 13, 100, 1234, 2999]
    leaves = [adam_leaf((4,), count=c) for c in counts]
    (t,) = cuda_optim.tables(leaves, ADAM, 384)
    assert t.rc.dtype == np.float32
    for (r1, r2), c in zip(t.rc, counts):
        # the reciprocal in double, then rounded (ATen's division of a
        # CUDA tensor by a Python float), not a float32 division
        assert r1 == np.float32(1.0 / (1 - ADAM.b1 ** c))
        assert r2 == np.float32(1.0 / (1 - ADAM.b2 ** c))
    f32_first = [np.float32(1.0) / np.float32(1 - ADAM.b2 ** c)
                 for c in counts]
    assert any(a != b for a, b in zip(t.rc[:, 1], f32_first))
    s = cuda_optim.scalars(3e-4, ADAM)
    want = torch.tensor([3e-4, 1e-4, 0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8],
                        dtype=torch.float64).float().numpy()
    assert s.dtype == np.float32 and s.tolist() == want.tolist()
    assert s[3] == np.float32(0.09999999999999998)


def test_k9_tables_refuse_what_the_kernel_does_not_take():
    p = torch.randn(4, 6)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    bad = [Leaf(p.t(), None, m.t(), v.t(), 1),  # strided p, m, v
           Leaf(p, p.double(), m, v, 1),  # a float64 gradient
           Leaf(p, torch.randn(6, 4), m, v, 1),  # another shape
           Leaf(p.double(), None, m.double(), v.double(), 1)]
    for leaf in bad:
        with pytest.raises(ValueError, match="K9"):
            cuda_optim.tables([leaf], ADAM, 384)
    q = torch.randn(2, 3, 2, 2, 2)
    g = torch.randn(2, 2, 2, 3, 2).permute(0, 3, 1, 2, 4)
    with pytest.raises(ValueError, match="at most 4"):
        cuda_optim.tables([Leaf(q, g, None, None, 0)], SGD, 384)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_optim.multi_tensor_update([adam_leaf((3,))], 1e-3, ADAM)


# -- the leaves of an update and the plain loop -------------------------------


def model_state(config):
    gen = torch.Generator().manual_seed(3)
    params = {"conv": torch.randn(4, 6, 3, 3, generator=gen),
              "bias": torch.randn(4, generator=gen),
              "frozen": torch.randn(5, generator=gen),
              "unreached": torch.randn(3, 2, generator=gen),
              "empty": torch.randn(0, 3, generator=gen)}
    state = optim.init_opt_state(params, config)
    if config.kind != "sgd":
        for i, n in enumerate(params):
            state["count"][n] = 5 * i  # mixed step counts
            state["mu"][n] = torch.randn(params[n].shape, generator=gen) * 1e-3
            state["nu"][n] = torch.rand(params[n].shape, generator=gen) * 1e-6
    grads = {"conv": torch.randn(4, 6, 3, 3, generator=gen).contiguous(
                 memory_format=torch.channels_last),
             "bias": torch.randn(4, generator=gen), "unreached": None,
             "frozen": torch.randn(5, generator=gen),
             "empty": torch.randn(0, 3, generator=gen)}
    active = {"conv": True, "bias": True, "frozen": False, "unreached": True,
              "empty": True}
    return params, state, grads, active


def test_active_leaves_leave_out_inactive_and_advance_counts():
    params, state, grads, active = model_state(ADAM)
    counts = dict(state["count"])
    leaves = optim.active_leaves(params, grads, state, active, ADAM)
    want = [params[n] for n in active if active[n]]
    assert len(leaves) == len(want)
    assert all(leaf.p is p for leaf, p in zip(leaves, want))
    assert [leaf.count for leaf in leaves] == [counts[n] + 1 for n in active
                                               if active[n]]
    assert state["count"] == {n: counts[n] + active[n] for n in counts}
    assert leaves[2].g is None
    (t,) = cuda_optim.tables(leaves, ADAM, 384)
    assert params["frozen"].data_ptr() not in t.ptrs
    assert len(t.numel) == 3  # the empty leaf left out of the table too


@pytest.mark.parametrize("config", [ADAM, SGD], ids=["adam", "sgd"])
def test_plain_update_equals_the_old_loop(config):
    params, state, grads, active = model_state(config)
    old = ({n: p.clone() for n, p in params.items()},
           {k: dict(v) if k == "count" else
            {n: t.clone() for n, t in v.items()} for k, v in state.items()})
    for _ in range(3):
        optim.apply_updates(params, grads, state, active, 1e-3, config)
        old_loop(old[0], grads, old[1], active, 1e-3, config)
    for n in params:
        assert torch.equal(params[n], old[0][n]), n
    if config.kind != "sgd":
        assert state["count"] == old[1]["count"]
        for k in ("mu", "nu"):
            for n in params:
                assert torch.equal(state[k][n], old[1][k][n]), (k, n)


@pytest.mark.parametrize("config", [ADAM, SGD], ids=["adam", "sgd"])
def test_plain_update_none_and_channels_last_gradients(config):
    """A None gradient updates as zeros (weight decay still applies); a
    channels_last gradient as its contiguous copy."""
    params, state, grads, active = model_state(config)
    twin = ({n: p.clone() for n, p in params.items()},
            {k: dict(v) if k == "count" else
             {n: t.clone() for n, t in v.items()} for k, v in state.items()})
    dense = dict(grads, conv=grads["conv"].contiguous(),
                 unreached=torch.zeros(3, 2))
    before = params["unreached"].clone()
    optim.apply_updates(params, grads, state, active, 1e-3, config)
    optim.apply_updates(twin[0], dense, twin[1], active, 1e-3, config)
    for n in params:
        assert torch.equal(params[n], twin[0][n]), n
    assert not torch.equal(params["unreached"], before)
    assert torch.equal(params["frozen"], model_state(config)[0]["frozen"])


def test_update_counters_count_leaf_updates():
    params, state, grads, active = model_state(ADAM)
    fused, plain = optim.fused_leaves, optim.plain_leaves
    optim.apply_updates(params, grads, state, active, 1e-3, ADAM)
    optim.apply_updates(params, grads, state, dict(active, bias=False), 1e-3,
                        ADAM)
    # every active leaf counts, the empty one too; the CPU takes the loop
    assert optim.plain_leaves - plain == 4 + 3
    assert optim.fused_leaves == fused


def test_update_counters_count_fused_leaves_on_the_card_path(monkeypatch):
    """A leaf on a CUDA device sends the whole call through K9 (here a
    stand-in that records it), counted as fused."""
    params, state, grads, active = model_state(ADAM)
    seen = []
    monkeypatch.setattr(cuda_optim, "multi_tensor_update",
                        lambda leaves, lr, config: seen.append(len(leaves)))
    leaf = types.SimpleNamespace(p=types.SimpleNamespace(is_cuda=True))
    monkeypatch.setattr(optim, "active_leaves",
                        lambda *a: [leaf] * 4)
    fused, plain = optim.fused_leaves, optim.plain_leaves
    optim.apply_updates(params, grads, state, active, 1e-3, ADAM)
    assert seen == [4]
    assert (optim.fused_leaves - fused, optim.plain_leaves - plain) == (4, 0)


# -- the benchmark's view -----------------------------------------------------


def global_names() -> list:
    source = (ROOT / "dgod_tpu_torch" / "csrc" /
              "multi_tensor_update.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)\s*\(", source)


def test_k9_kernel_names_match_no_port_pattern():
    sys.path.insert(0, str(ROOT))
    from perfbench.bench import kernels

    names = global_names()
    assert names == ["k9_multi_tensor_adam", "k9_multi_tensor_sgd"]
    patterns = [p for cat, p in kernels.CATEGORIES if cat.endswith("(port)")]
    for path in sorted((ROOT / "perfbench" / "kernels").glob("K*.py")):
        patterns.append(re.search(r'^PATTERN = r"(.*)"$', path.read_text(),
                                  re.M).group(1))
    assert len(patterns) >= 14
    for name in names:
        # as the profiler names them: namespace and parameter types
        full = f"(anonymous namespace)::{name}(K9Leaves, K9Scalars)"
        for pattern in patterns:
            assert not re.search(pattern, full), (name, pattern)


def fused_share_reader():
    path = ROOT / "perfbench" / "metrics" / "update_fused_share.train.py"
    spec = importlib.util.spec_from_file_location("update_fused_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_update_fused_share_reads_the_program_counters(monkeypatch):
    read = fused_share_reader()
    train = types.SimpleNamespace(path="train")
    name = "dgod_tpu_torch.train.optim"
    monkeypatch.setitem(sys.modules, name, None)  # import raises
    assert read(train) is None
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert read(train) is None  # a program without the counters
    counters = types.ModuleType(name)
    counters.fused_leaves, counters.plain_leaves = 0, 0
    monkeypatch.setitem(sys.modules, name, counters)
    assert read(train) is None  # no update yet
    counters.fused_leaves, counters.plain_leaves = 1677, 0
    assert read(train) == 100.0
    counters.plain_leaves = 1677
    assert read(train) == 50.0
    assert read(types.SimpleNamespace(path="predict")) is None


# -- the card -----------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("config", [ADAM, SGD], ids=["adam", "sgd"])
def test_card_k9_equals_the_plain_loop_bitwise(card, config):
    gen = torch.Generator(device=card).manual_seed(0)
    shapes = [(64, 3, 7, 7), (64,), (768, 768), (5,), (3, 9), (27, 64),
              (256, 256, 3, 3), (1, 1, 1), (2888, 768)]
    params = {f"p{i}": torch.randn(s, generator=gen, device=card) * 0.02
              for i, s in enumerate(shapes)}
    state = optim.init_opt_state(params, config)
    twin = ({n: p.clone() for n, p in params.items()},
            {k: dict(v) if k == "count" else
             {n: t.clone() for n, t in v.items()} for k, v in state.items()})
    flat = torch.randn(sum(p.numel() for p in params.values()) + 1,
                       generator=gen, device=card) * 1e-3
    for step in range(3):
        active = {n: (i + step) % 4 != 0 for i, n in enumerate(params)}
        grads, offset = {}, 1
        for i, (n, p) in enumerate(params.items()):
            if i % 5 == 2:
                continue  # None
            if p.dim() == 4:
                grads[n] = torch.randn(p.shape, generator=gen, device=card
                                       ).contiguous(
                    memory_format=torch.channels_last) * 1e-3
            else:  # a view at a 4-byte offset of one buffer
                grads[n] = flat[offset:offset + p.numel()].view(p.shape)
                offset += p.numel()
        launches = cuda_optim.launches
        optim.apply_updates(params, grads, state, active, 1e-3, config)
        assert cuda_optim.launches - launches == 1
        optim.update_plain(optim.active_leaves(twin[0], grads, twin[1],
                                               active, config), 1e-3, config)
    torch.cuda.synchronize()
    for n in params:
        assert torch.equal(params[n], twin[0][n]), n
        if config.kind != "sgd":
            assert torch.equal(state["mu"][n], twin[1]["mu"][n]), n
            assert torch.equal(state["nu"][n], twin[1]["nu"][n]), n
    if config.kind != "sgd":
        assert state["count"] == twin[1]["count"]
