"""DG Faster R-CNN on ViTDet-B (`dgod_tpu_torch/models/vitdet.py`) against
its plain reference (`perfbench/reference/models/vitdet.py`, detectron2's
equations), at tiny sizes in float32 with seeded random weights:

- the backbone's P2-P6 and its parameters' gradients, on a 4x8 token grid
  that 3x3 windows must pad and whose global tables are interpolated,
  drop-path on;
- the attention's plain version (what K7/K8 compute on the card) against a
  softmax over the materialised [N, N] bias, forward and backward, with
  the bias gradients as K8 forms them: row sums of dS over each grid row
  and column;
- drop-path from given uniforms: a dropped branch adds exactly 0;
- the fused pairs (0,1) and (0,2) of DGFRCNNModel(backbone="vitdet_b")
  against the reference's, as the benchmark's check runs them;
- `--backbone vitdet_b` through the CLI: Trainer's fused pairs with Adam at
  ViTDet's lr, validation through make_eval_step;
- the default ResNet-50 FPN model's leaves, weights and draws from a seed
  as before the backbone became a choice.
"""

import hashlib

import pytest
import torch

from dgod_tpu_torch.models import dg_frcnn, vitdet
from dgod_tpu_torch.models.backbone import FRCNNBackbone
from dgod_tpu_torch.ops import attention
from perfbench.reference.models import vitdet as ref_vitdet

CANVAS = (64, 128)
TINY = dict(patch_size=16, embed_dim=32, depth=4, num_heads=2,
            mlp_ratio=4.0, window_size=3, global_blocks=[1, 3],
            drop_path_rate=0.1, pretrain_img_size=224, img_size=128,
            out_channels=256, scale_factors=[4.0, 2.0, 1.0, 0.5],
            layer_norm_eps=1e-6, pixel_mean=[123.675, 116.28, 103.53],
            pixel_std=[58.395, 57.12, 57.375])


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair():
    """The port's tiny backbone with seeded weights, and the reference's
    holding the same."""
    port = vitdet.ViTDetBackbone(CANVAS, vitdet.ViTDetConfig.of(TINY))
    port.reset_parameters(torch.Generator().manual_seed(0))
    ref = ref_vitdet.Backbone(TINY)
    ref.load_state_dict(port.state_dict())
    return port, ref


def test_vitdet_backbone_matches_reference():
    port, ref = _pair()
    gen = torch.Generator().manual_seed(1)
    images = torch.rand((2, 3) + CANVAS, generator=gen)
    drop = torch.rand((2, TINY["depth"], 2), generator=gen)
    drop[0, 3] = 0.95  # block 3 (rate 0.1) drops both branches of image 0
    got, _ = port(images, drop)
    ref.drop_path = drop
    want, _ = ref(images)
    assert [tuple(p.shape[2:]) for p in got] == [
        (16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
    weights = [torch.randn(p.shape, generator=gen) for p in got]
    for g, w, weight in zip(got, want, weights):
        assert g.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    for model, out in ((port, got), (ref, want)):
        sum((p * w).sum() for p, w in zip(out, weights)).backward()
    # float32 sums in other orders: within 1e-5 of each leaf's largest
    # gradient (the gaps read 3e-6 at most)
    # The k part's bias has no gradient in exact arithmetic (a constant
    # logit per softmax row): on both sides it is nought beside the q
    # part's.
    grads = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        want = grads[name].grad
        if name.endswith("attn.k.bias"):
            scale = float(grads[name[:-6] + "q.bias"].grad.abs().max())
            assert float(p.grad.abs().max()) < 1e-5 * scale, name
            assert float(want.abs().max()) < 1e-5 * scale, name
            continue
        torch.testing.assert_close(p.grad, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=name)
    assert port.net.blocks[3].attn.rel_pos_h.shape[0] == 2 * 8 - 1


@pytest.mark.parametrize("grid", [(3, 3), (4, 8)])
def test_relpos_attention_against_materialised_bias(grid):
    gen = torch.Generator().manual_seed(2)
    B, heads, D = 2, 3, 8
    KH, KW = grid
    N = KH * KW
    qkv = torch.randn((B, N, 3, heads, D), generator=gen, requires_grad=True)
    rel_h = torch.randn((B, heads, N, KH), generator=gen, requires_grad=True)
    rel_w = torch.randn((B, heads, N, KW), generator=gen, requires_grad=True)
    scale = D ** -0.5
    out = attention.relpos_attention(qkv, rel_h, rel_w, scale)
    n = torch.arange(N)
    bias = (rel_h[..., n // KW] + rel_w[..., n % KW]).detach() \
        .requires_grad_(True)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    want = (torch.softmax(scale * q @ k.transpose(-1, -2) + bias, -1) @ v) \
        .transpose(1, 2)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    g = torch.randn(out.shape, generator=gen)
    dqkv, drh, drw = torch.autograd.grad(out, (qkv, rel_h, rel_w), g)
    want_dqkv, ds = torch.autograd.grad(want, (qkv, bias), g)
    torch.testing.assert_close(dqkv, want_dqkv, rtol=1e-5, atol=1e-6)
    ds = ds.view(B, heads, N, KH, KW)
    torch.testing.assert_close(drh, ds.sum(-1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(drw, ds.sum(-2), rtol=1e-5, atol=1e-6)


def test_drop_path_dropped_branch_adds_nothing():
    port, _ = _pair()
    block = port.net.blocks[3]
    keep = 1.0 - block.drop_rate
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 8, TINY["embed_dim"]), generator=gen)
    u = torch.tensor([[0.99, 0.99], [0.0, 0.0]])  # image 0 drops, 1 keeps
    out = block(x, u)
    assert torch.equal(out[0], x[0])
    assert not torch.equal(out[1], x[1])
    # a kept branch is scaled by 1 / keep
    attn_only = block(x, torch.tensor([[0.0, 0.99], [0.0, 0.99]]))
    plain = block.attn(block.norm1(x))
    torch.testing.assert_close(attn_only, x + plain / keep)
    assert 0.0 < block.drop_rate == pytest.approx(0.1)
    assert port.net.blocks[0].drop_rate == 0.0


def test_vitdet_pairs_match_reference():
    """The fused pairs (0,1) and (0,2) from one state, batch and draws, as
    the benchmark's check runs them: both halves' losses and the first
    update per leaf agree to float32's rounding."""
    from perfbench.bench import models, train
    from perfbench.tests.tiny import tiny_cell

    cell = tiny_cell("vitdet-dg_train")
    c, t = cell["config"], cell["traffic"]
    cpu = torch.device("cpu")
    batch = train.to_device(train.host_batches(t, c, 11)[0], cpu)
    draws = train.draw_maker(c, t["batch"], t["max_gt"], cpu, 11)
    state = models.make_state(c, 11, cpu, batch["image"])
    side = train.program_side(c, cpu, state)
    assert isinstance(side.model.detector.backbone, vitdet.ViTDetBackbone)
    plan = [(k, batch, draws(True), draws(False)) for k in (1, 2)]
    assert plan[0][2][-1].shape == (t["batch"], TINY["depth"], 2)
    got = train.first_pairs(side, plan, state)
    ref = train.reference_readings(c, cpu, state, plan)
    assert got["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    assert got["g1"].keys() == ref["g1"].keys()
    top = max(ref["g1"].values())
    for name, value in ref["g1"].items():
        assert got["g1"][name] == pytest.approx(value, rel=1e-4,
                                                abs=1e-5 * top), name
    # the first update moved every leaf of the backbone
    backbone = [n for n in ref["g1"] if ".backbone." in n]
    assert backbone and all(got["g1"][n] > 0 for n in backbone)


def test_cli_backbone_vitdet_trains_and_validates(tmp_path, monkeypatch):
    from dgod_tpu_torch import cli
    from dgod_tpu_torch.data import transforms as T
    from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig
    from dgod_tpu_torch.train import harness

    from test_torch_cli import write_domains

    monkeypatch.setattr(T, "CANVAS", CANVAS)
    monkeypatch.setattr(T, "TRAIN_SIZE", (60, 120))
    monkeypatch.setattr(T, "MIN_SIZE", 60)
    monkeypatch.setattr(T, "MAX_SIZE", 120)
    monkeypatch.setattr(T, "MIN_AREA", 1.0)
    small = FRCNNConfig(rpn_pre_nms_train=256, rpn_pre_nms_test=256,
                        rpn_post_nms_train=256, rpn_post_nms_test=32,
                        rpn_batch_per_image=64, box_batch_per_image=64)
    frcnn = dg_frcnn.DGFRCNNModel
    monkeypatch.setattr(dg_frcnn, "DGFRCNNModel", lambda **kw: frcnn(
        config=small, compute_dtype=torch.float32,
        vit=vitdet.ViTDetConfig.of(TINY), **kw))
    seen = {}
    trainer = harness.Trainer

    def spy(model, *a, **kw):
        t = trainer(model, *a, **kw)
        seen.update(model=model, opt=t.opt_config, lr=t.base_lr,
                    pairs=t.fused_pairs)
        return t

    monkeypatch.setattr(cli, "Trainer", spy)
    root = str(tmp_path)
    write_domains(root, [("a", "train"), ("b", "train"), ("a", "val"),
                         ("b", "val"), ("i", "val")], n=1)
    result = cli.main(["--model", "FRCNN", "--backbone", "vitdet_b",
                       "--exp", "dg", "--source_domains", "AB",
                       "--target_domains", "I", "--batch_size", "2",
                       "--max_epochs", "1", "--data_root", root,
                       "--weights_folder", str(tmp_path / "w"),
                       "--weights_file", "v"], device="cpu")
    assert 0.0 <= result["map_50"] <= 1.0
    assert isinstance(seen["model"].detector.backbone, vitdet.ViTDetBackbone)
    assert (seen["opt"].kind, seen["opt"].weight_decay, seen["lr"]) == (
        "adam", 1e-4, 1e-4)
    assert seen["pairs"] is True
    with pytest.raises(ValueError, match="DG Faster R-CNN"):
        cli.main(["--model", "FCOS", "--backbone", "vitdet_b",
                  "--data_root", root], device="cpu")


def test_resnet_default_unchanged():
    """The default model's leaves, weights and draws from a seed, as the
    port gave them before the backbone became a choice (literal digests)."""
    model = dg_frcnn.DGFRCNNModel(canvas=CANVAS,
                                  backbone_block_counts=(1, 1, 1, 1),
                                  compute_dtype=torch.float32, device="cpu",
                                  seed=0)
    digest = hashlib.sha256()
    state = model.state_dict()
    for name, t in state.items():
        digest.update(name.encode())
        digest.update(str(tuple(t.shape)).encode())
        digest.update(t.contiguous().numpy().tobytes())
    assert (digest.hexdigest(), len(state)) == (
        "61258382e7dc68fcc254e8957da3335d40239b7b1526a36832617250a8b0c0c5",
        145)
    draws = model.make_draws(2, 32, torch.Generator().manual_seed(3))
    assert draws.drop_path is None
    digest = hashlib.sha256()
    for t in draws[:4]:
        digest.update(t.numpy().tobytes())
    assert digest.hexdigest() == \
        "c25deaecd39bb5086d56c2368cff0eab557e951ea1aa0fd40058d7236f18076a"
    assert isinstance(model.detector.backbone, FRCNNBackbone)


def test_relpos_kernels_take_every_grid_the_wrapper_passes():
    """K7/K8's C entry points dispatch on (KWP, R): the grid row padded to
    16 columns and the rows of a key chunk (7 or 4 for 16-column rows, 1
    otherwise). Every grid the wrapper lets through (KW up to MAX_KW) has
    an instantiation in the source, and the wrapper refuses what the
    kernels do not take before it builds anything."""
    import re

    from dgod_tpu_torch.ops import cuda_attention
    from dgod_tpu_torch.ops._build import CSRC

    src = (CSRC / "relpos_attention.cu").read_text()
    cases = {(int(a), int(b)) for a, b in re.findall(
        r"case \d+ \* 16 \+ \d+: return FN<(\d+), (\d+)>", src)}
    for kw in range(1, cuda_attention.MAX_KW + 1):
        kwp = -(-kw // 16) * 16
        for kh in range(1, 40):
            r = (7 if kh % 7 == 0 else 4) if kwp == 16 else 1
            assert (kwp, r) in cases, (kh, kw)
    qkv = torch.zeros((1, 4, 3, 1, 64), dtype=torch.bfloat16)
    rel = torch.zeros((1, 1, 4, 2))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_attention.relpos_attention_cuda(qkv, rel, rel, 0.125)


def test_relpos_kernel_names_match_the_benchmark_patterns():
    """Every `__global__` of K7/K8's source is named so that the
    benchmark's `perfbench/kernels/K7.py` or `K8.py` PATTERN finds its
    device time: a kernel renamed by a redesign would move attention time
    out of `attention_ms.train` unseen."""
    import re

    from dgod_tpu_torch.ops._build import CSRC
    from perfbench.kernels import K7, K8

    src = (CSRC / "relpos_attention.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(\w+)\s*\(", src)
    assert len(names) >= 4, names
    for name in names:
        assert re.search(K7.PATTERN, name) or re.search(K8.PATTERN, name), \
            name


def test_tensor_parallelism_refuses_vitdet(monkeypatch):
    """`shard_model` would split only the heads: it refuses the ViTDet
    model, naming the backbone; a model axis of 1 (data parallelism) takes
    it as it is."""
    from dgod_tpu_torch.parallel.mesh import Mesh
    from dgod_tpu_torch.parallel.tensor_parallel import shard_model

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    model = dg_frcnn.DGFRCNNModel(canvas=CANVAS, backbone="vitdet_b",
                                  vit=vitdet.ViTDetConfig.of(TINY),
                                  compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="ViTDetBackbone"):
        shard_model(model, Mesh(1, 2))
    assert shard_model(model, Mesh(2, 1)) == {}
