"""The builders (perfbench/builders) and the kernel files (perfbench/kernels)
read the existing cells as the harness did before they existed: every FLOP
count, every kernel's work and bound, the weights and the draws, held to
the values the harness gave then, here as literals. Also: each kernel
file's pattern is its row of the frozen CATEGORIES, the optimizer object
passes whole, and a family with no builder is refused."""

import hashlib
import json
import re
import types
from pathlib import Path

import pytest
import torch

from perfbench.bench import build, common, kernels, models, readers, train
from perfbench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 77

# The harness's readings before the builders, at the benchmark's sizes
# ("full") and tiny.py's ("tiny").

# model FLOPs per image (train at the cell's batch, 1 for predict;
# predict), cell/size
FLOPS = {
    "frcnn-dg_train/full": (765233646880.0, 305178054656.0),
    "frcnn-dg_train/tiny": (11838585376.0, 3109153792.0),
    "fcos-dg_train/full": (578254155744.0, 290258966528.0),
    "fcos-dg_train/tiny": (5500625344.0, 2364167168.0),
    "frcnn-predict_b1/full": (765233646880.0, 305178054656.0),
    "frcnn-predict_b1/tiny": (11838585376.0, 3109153792.0),
}
# one launch"s bound in s, bytes and float32 operations,
# configuration/size/path/kernel (train at the traffic"s batch, predict
# at 1; the traffic"s max_gt)
WORK = {
    "frcnn_r50_fpn_dg/full/train/K1":
        (6.136908417910448e-05, 205586432, 1644167168),
    "frcnn_r50_fpn_dg/full/train/K2":
        (0.00013640535880597016, 456957952, 1644167168),
    "frcnn_r50_fpn_dg/full/train/K3": (2.6513576119402987e-06, 8882048, 0),
    "frcnn_r50_fpn_dg/full/train/K5":
        (1.002837014925373e-06, 3359504, 2056800),
    "frcnn_r50_fpn_dg/full/train/K6": (1.0961194029850746e-07, 367200, 0),
    "frcnn_r50_fpn_dg/full/predict/K1":
        (1.498268656716418e-05, 50192000, 401408000),
    "frcnn_r50_fpn_dg/full/predict/K2":
        (2.436222089552239e-05, 81613440, 401408000),
    "frcnn_r50_fpn_dg/full/predict/K3": (1.1032167164179105e-06, 3695776, 0),
    "frcnn_r50_fpn_dg/full/predict/K5":
        (6.684716417910448e-08, 223938, 137100),
    "frcnn_r50_fpn_dg/full/predict/K6": (1.3701492537313432e-08, 45900, 0),
    "frcnn_r50_fpn_dg/tiny/train/K1":
        (1.917783880597015e-06, 6424576, 51380224),
    "frcnn_r50_fpn_dg/tiny/train/K2":
        (2.1256405970149254e-06, 7120896, 51380224),
    "frcnn_r50_fpn_dg/tiny/train/K3": (1.498268656716418e-08, 50192, 0),
    "frcnn_r50_fpn_dg/tiny/train/K5": (1.8668656716417912e-08, 62540, 38280),
    "frcnn_r50_fpn_dg/tiny/train/K6": (1.3970149253731344e-09, 4680, 0),
    "frcnn_r50_fpn_dg/tiny/predict/K1":
        (4.794459701492538e-07, 1606144, 12845056),
    "frcnn_r50_fpn_dg/tiny/predict/K2":
        (5.83374328358209e-07, 1954304, 12845056),
    "frcnn_r50_fpn_dg/tiny/predict/K3": (1.237731343283582e-08, 41464, 0),
    "frcnn_r50_fpn_dg/tiny/predict/K5": (9.334328358208956e-09, 31270, 19140),
    "frcnn_r50_fpn_dg/tiny/predict/K6": (6.985074626865672e-10, 2340, 0),
    "fcos_r50_fpn_dg/full/train/K4": (2.2588179104477611e-07, 756704, 0),
    "fcos_r50_fpn_dg/full/train/K6": (3.7516417910447763e-08, 125680, 0),
    "fcos_r50_fpn_dg/full/predict/K4": (9.260179104477611e-08, 310216, 0),
    "fcos_r50_fpn_dg/full/predict/K6": (4.6895522388059704e-09, 15710, 0),
    "fcos_r50_fpn_dg/tiny/train/K4": (1.5498507462686567e-09, 5192, 0),
    "fcos_r50_fpn_dg/tiny/train/K6": (1.0477611940298507e-09, 3510, 0),
    "fcos_r50_fpn_dg/tiny/predict/K4": (1.1832835820895522e-09, 3964, 0),
    "fcos_r50_fpn_dg/tiny/predict/K6": (5.238805970149253e-10, 1755, 0),
}
# make_state at tiny.py"s sizes, seed SEED: sha256 of each leaf"s name and
# shape in order and each parameter"s bytes; the number of leaves; the
# sum and the sum of squares of the FrozenBatchNorm buffers
STATE = {
    "frcnn-dg_train":
        ("8a18616c5e34c987296680743bbcdee1131cfd249924e075bb6cab0d334b5747",
        145, 15704.75488338538, 22038.079787730778),
    "fcos-dg_train":
        ("e3b2a2b73393f349187230e5ce447da9adfffbfa0da6ba9af496dc8d71c1025a",
        165, 15688.773117897566, 22028.819893771644),
}
# sha256 of the first DG cycle"s draws at tiny.py"s sizes, seed SEED
DRAWS = {
    "frcnn-dg_train":
        "e978c0925fa1a1402a76eb25b02046abc04f158ecab96e97dc12a246e28501ed",
    "fcos-dg_train":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
}


def _cell(name: str, size: str) -> dict:
    return common.load_cell(name) if size == "full" else tiny_cell(name)


@pytest.mark.parametrize("key", sorted(FLOPS))
def test_perfbench_builders_flops_as_before(key):
    name, size = key.split("/")
    cell = _cell(name, size)
    t = cell["traffic"]
    ctx = types.SimpleNamespace(config=cell["config"], s=types.SimpleNamespace(
        batch=t["batch"] if t["kind"] == "train" else 1))
    assert (readers.train_flops_per_image(ctx),
            readers.predict_flops_per_image(ctx)) == FLOPS[key]


CELL_OF = {"frcnn_r50_fpn_dg": "frcnn-dg_train",
           "fcos_r50_fpn_dg": "fcos-dg_train"}


@pytest.mark.parametrize("key", sorted(WORK))
def test_perfbench_kernel_bounds_as_before(key):
    config_name, size, path, kid = key.split("/")
    cell = _cell(CELL_OF[config_name], size)
    c, t = cell["config"], cell["traffic"]
    B = t["batch"] if path == "train" else 1
    got = (kernels.bound_s(kid, path, c, B, t["max_gt"]),
           *kernels.launch_work(kid, path, c, B, t["max_gt"]))
    assert got == WORK[key]


def test_perfbench_builders_list_the_kernels_as_before():
    """Each builder gives each path the kernels whose work the harness
    counted for its configuration before."""
    for config_name, name in CELL_OF.items():
        c = common.load_cell(name)["config"]
        for path in ("train", "predict"):
            want = {k.rsplit("/", 1)[1] for k in WORK
                    if k.startswith(f"{config_name}/full/{path}/")}
            assert set(common.builder(c).kernels_on(path, c)) == want


@pytest.mark.parametrize("name", sorted(STATE))
def test_perfbench_builders_weights_and_draws_as_before(name):
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    c, t = cell["config"], cell["traffic"]
    device = torch.device("cpu")
    batches = [train.to_device(b, device)
               for b in train.host_batches(t, c, SEED)]
    state = models.make_state(c, SEED, device, batches[0]["image"])
    params = dict(models.reference_model(c, device).named_parameters())
    digest, total, squares = hashlib.sha256(), 0.0, 0.0
    for n, v in state.items():
        digest.update(n.encode())
        digest.update(str(tuple(v.shape)).encode())
        if n in params:
            digest.update(v.contiguous().numpy().tobytes())
        else:
            total += float(v.double().sum())
            squares += float((v.double() ** 2).sum())
    want = STATE[name]
    assert (digest.hexdigest(), len(state)) == want[:2]
    # the buffers are statistics of a float32 forward on the CPU, whose
    # last bits may follow the CPU's instruction set
    assert (total, squares) == pytest.approx(want[2:], rel=1e-6)
    draws = train.draw_maker(c, t["batch"], t["max_gt"], device, SEED)
    digest = hashlib.sha256()
    for _ in t["pairs"]:
        for with_rpn in (True, False):
            for u in draws(with_rpn) or ():
                digest.update(b"none" if u is None else u.numpy().tobytes())
    assert digest.hexdigest() == DRAWS[name]


PORT_ROWS = {cat.split()[0]: (cat, p) for cat, p in kernels.CATEGORIES
             if cat.endswith("(port)")}
# kernel names of the existing cells' traces, each with its category as the
# first matching row of the frozen CATEGORIES gives it
NAMES = ["(anonymous namespace)::fwd_kernel<float>",
         "(anonymous namespace)::bwd_gather_kernel<__nv_bfloat16>",
         "fcos_match_kernel", "iou_match_kernel", "init_best",
         "nms_topk_kernel", "decode_kernel", "scan_kernel",
         "sm90_xmma_fprop_implicit_gemm", "radixSort",
         "index_elementwise_kernel", "reduce_kernel",
         "vectorized_elementwise_kernel", "Memcpy DtoH", "mystery"]


def _first_row(name: str) -> str:
    return next((cat for cat, p in kernels.CATEGORIES if re.search(p, name)),
                "other")


def test_perfbench_kernel_files_are_their_categories():
    """Each kernel file with a row in the frozen CATEGORIES has that row's
    category and pattern, and those files claim names in the rows' order;
    a file with no row (a kernel added since) is not held to one. A
    kernel's name falls in the category that the first matching row of
    CATEGORIES names, over every kernel file as over each cell's."""
    files = common.kernel_files()
    assert set(PORT_ROWS) <= set(files)
    held = [kid for kid in files if kid in PORT_ROWS]
    assert held == list(PORT_ROWS)
    for kid in held:
        assert (files[kid].CATEGORY, files[kid].PATTERN) == PORT_ROWS[kid]
    cell_ids = [common.cell_kernels(common.load_cell(name)["config"], path)
                for name in CELL_OF.values() for path in ("train", "predict")]
    for name in NAMES:
        first = _first_row(name)
        kid = first.split()[0] if first.endswith("(port)") else None
        assert kernels.category(name) == first
        assert kernels.kernel_id(name) == kid
        for ids in cell_ids:
            if kid is None or kid in ids:
                assert kernels.category(name, ids) == first
                assert kernels.kernel_id(name, ids) == kid


def test_perfbench_launch_counts_read_the_kernel_files():
    """The launch counts of a cell are its kernels' counters, read through
    their files, and no other file's."""
    from dgod_tpu_torch.ops import (cuda_matchers, cuda_nms, cuda_proposals,
                                    cuda_roi_align)
    from perfbench import run

    want = {
        "K1": cuda_roi_align.fwd_launches, "K2": cuda_roi_align.bwd_launches,
        "K3": cuda_matchers.launches, "K4": cuda_matchers.fcos_launches,
        "K5": cuda_proposals.launches, "K6": cuda_nms.launches}
    assert run.launch_counts(tuple(want)) == want
    for name in CELL_OF.values():
        c = common.load_cell(name)["config"]
        for path in ("train", "predict"):
            ids = common.cell_kernels(c, path)
            assert run.launch_counts(ids) == {k: want[k] for k in ids}


def test_perfbench_optimizer_object_passes_whole():
    from dgod_tpu_torch.train import optim

    config = {"optimizer": {"kind": "adam", "lr": 1e-4, "weight_decay": 1e-4,
                            "b2": 0.99, "eps": 1e-6}}
    assert build.opt_config(optim, config) == optim.OptConfig(
        "adam", weight_decay=1e-4, b2=0.99, eps=1e-6)
    config["optimizer"]["layer_decay"] = 0.7  # a setting the port lacks
    with pytest.raises(TypeError):
        build.opt_config(optim, config)


def test_perfbench_kernel_without_a_file_is_refused():
    with pytest.raises(common.CellError):
        common.kernel_files(("K1", "NO_SUCH_KERNEL"))


def test_perfbench_family_without_a_builder_is_refused():
    config = json.loads(
        (ROOT / "perfbench/configs/frcnn_r50_fpn_dg.json").read_text())
    config["family"] = "NO_SUCH_FAMILY"
    with pytest.raises(common.CellError):
        common.builder(config)
