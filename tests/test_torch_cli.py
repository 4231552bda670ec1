"""The port's CLI (`dgod_tpu_torch.cli`) against the JAX package's.

- `vars(parser_args([]))` equals JAX's: the same flags and defaults, but
  for the port's own `--backbone` (DG Faster R-CNN on ViTDet-B,
  tests/test_torch_vitdet.py);
- `cli.main(argv, device="cpu")` end to end on PNGs and CSVs (arg parsing
  -> datasets -> loaders -> Trainer.fit -> checkpoint -> test sweep) for
  both families, reduced canvas and backbone depth: it returns `map_50`,
  writes the `.ckpt`, and a `--max_epochs 0` rerun (warm start, no
  training) reproduces the test mAP;
- `--reference_quirks` reaches the FCOS loss config, the loader and the
  fused-pair switch, as tests/test_cli.py checks for JAX;
- `--torch_weights` warm-starts the CLI's model from a torchvision
  checkpoint (a synthesised COCO FCOS `.pth`, full depth, as the JAX
  tests/test_weights_e2e.py builds it);
- `--process_loader` trains and tests as the thread loader does (a child
  process spawned), and `--mesh data=3` on a one-rank world raises that
  it needs 3 devices (a mesh must hold every rank;
  tests/test_torch_parallel.py runs `--mesh` on 2 ranks).
"""

import os

import numpy as np
import pytest
import torch

from dgod_tpu.cli import parser_args as jax_parser_args
from dgod_tpu_torch import cli
from dgod_tpu_torch.data import png
from dgod_tpu_torch.data import transforms as T
from dgod_tpu_torch.models import dg_fcos, dg_frcnn
from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig

SMALL_FRCNN = FRCNNConfig(rpn_pre_nms_train=256, rpn_pre_nms_test=256,
                          rpn_post_nms_train=256, rpn_post_nms_test=256,
                          rpn_batch_per_image=64, box_batch_per_image=64)


def test_flag_surface_matches_jax():
    def port(argv):
        got = vars(cli.parser_args(argv))
        assert got.pop("backbone") == "resnet50_fpn"  # the port's own flag
        return got

    assert port([]) == vars(jax_parser_args([]))
    argv = ["--model", "FCOS", "--exp", "dg", "--reg_weights", "1", "2", "3",
            "4", "5", "--batch_size", "4", "--reference_quirks"]
    assert port(argv) == vars(jax_parser_args(argv))


def write_domains(root, letters_splits, n=4, hw=(60, 120)):
    """PNGs (the port's writer) and CSVs in DOMAIN_SPECS's layout, one
    'car' box per image."""
    rng = np.random.RandomState(0)
    h, w = hw
    for letter, split in letters_splits:
        name, csv_tpl, root_tpl = cli.DOMAIN_SPECS[letter]
        img_root = os.path.join(root, root_tpl.format(split=split))
        os.makedirs(img_root, exist_ok=True)
        rows = []
        for i in range(n):
            fname = f"{name}_{split}_{i}.png"
            img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
            img[15:40, 20:60] = (250, 30, 30)
            png.write_png(os.path.join(img_root, fname), img)
            rows.append(f"{fname},20 15 60 40,3")
        csv_path = os.path.join(root, csv_tpl.format(split=split))
        os.makedirs(os.path.dirname(csv_path), exist_ok=True)
        with open(csv_path, "w") as f:
            f.write("image_name,BoxesString,LabelsString\n")
            f.write("\n".join(rows) + "\n")


@pytest.fixture
def small(monkeypatch):
    """64x128 canvas, backbone blocks (1,1,1,1), float32, small FRCNN
    sampling sizes; one intra-op thread (the suite runs several workers on
    the machine's cores, and torch's thread pools then oversubscribe it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(T, "CANVAS", (64, 128))
    monkeypatch.setattr(T, "TRAIN_SIZE", (60, 120))
    monkeypatch.setattr(T, "MIN_SIZE", 60)
    monkeypatch.setattr(T, "MAX_SIZE", 120)
    monkeypatch.setattr(T, "MIN_AREA", 1.0)
    small_kw = dict(backbone_block_counts=(1, 1, 1, 1),
                    compute_dtype=torch.float32)
    frcnn, fcos = dg_frcnn.DGFRCNNModel, dg_fcos.DGFCOSModel
    monkeypatch.setattr(dg_frcnn, "DGFRCNNModel", lambda **kw: frcnn(
        config=SMALL_FRCNN, **small_kw, **kw))
    monkeypatch.setattr(dg_fcos, "DGFCOSModel",
                        lambda **kw: fcos(**small_kw, **kw))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family,exp", [("FRCNN", "dg"), ("FCOS", "dg"),
                                        ("FCOS", "non_dg")])
def test_cli_main_end_to_end(tmp_path, small, family, exp):
    root = str(tmp_path)
    write_domains(root, [("a", "train"), ("b", "train"), ("a", "val"),
                         ("b", "val"), ("i", "val")])
    argv = ["--model", family, "--exp", exp,
            "--source_domains", "AB", "--target_domains", "I",
            "--batch_size", "4", "--eval_batch_size", "3",
            "--data_root", root, "--weights_folder", os.path.join(root, "w"),
            "--weights_file", "t",
            "--metrics_path", os.path.join(root, "metrics.jsonl")]
    result = cli.main(argv + ["--max_epochs", "1"], device="cpu")
    assert 0.0 <= result["map_50"] <= 1.0
    ckpt = os.path.join(root, "w", "t.ckpt")
    assert os.path.exists(ckpt)
    saved = torch.load(ckpt, weights_only=True)
    assert saved["meta"]["epoch"] == 0
    assert all(torch.isfinite(v).all() for v in saved["params"].values())
    with open(os.path.join(root, "metrics.jsonl")) as f:
        assert '"scope": "epoch"' in f.read()
    again = cli.main(argv + ["--max_epochs", "0"], device="cpu")
    assert again["map_50"] == result["map_50"]
    np.testing.assert_array_equal(again["map_per_class"],
                                  result["map_per_class"])


def test_cli_reference_quirks_flag(tmp_path, monkeypatch):
    """--reference_quirks plumbs end to end: the FCOS loss config gets both
    quirk flags, the loader re-samples the dg replay, and the fused pair
    step is off (it cannot reproduce re-sampled augmentation)."""
    captured = {}

    class _StopTrainer:
        def __init__(self, model, train_loader, val_loader, **kw):
            captured["model"] = model
            captured["train_loader"] = train_loader
            captured["kw"] = kw
            raise RuntimeError("stop-before-training")

    monkeypatch.setattr(cli, "Trainer", _StopTrainer)
    monkeypatch.setattr(dg_fcos, "DGFCOSModel",
                        lambda **kw: type("M", (), kw))
    root = str(tmp_path)
    write_domains(root, [("a", "train"), ("a", "val"), ("i", "val")], n=1)
    argv = ["--model", "FCOS", "--exp", "dg", "--source_domains", "A",
            "--target_domains", "I", "--data_root", root,
            "--weights_folder", str(tmp_path / "w"), "--weights_file", "q"]
    for quirks in (True, False):
        with pytest.raises(RuntimeError, match="stop-before-training"):
            cli.main(argv + ["--reference_quirks"] * quirks, device="cpu")
        cfg = captured["model"].loss_config
        assert cfg.single_gt_quirk is quirks
        assert cfg.exact_reference_area is quirks
        assert captured["train_loader"].resample_replay is quirks
        assert captured["kw"]["fused_pairs"] is not quirks
        assert captured["kw"]["device"] == torch.device("cpu")


def test_cli_torch_weights_warm_start(tmp_path, monkeypatch):
    """`--torch_weights X.pth` reaches the Trainer, which ports the file
    into the model before any step; a `--max_epochs 0` run then tests the
    warm-started weights. Full-depth FCOS (the checkpoint is a full
    ResNet-50) at a 64x128 canvas, one intra-op thread."""
    from test_weights_e2e import fcos_sd
    from dgod_tpu_torch.utils import weights as W

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k, v in (("CANVAS", (64, 128)), ("TRAIN_SIZE", (60, 120)),
                 ("MIN_SIZE", 60), ("MAX_SIZE", 120), ("MIN_AREA", 1.0)):
        monkeypatch.setattr(T, k, v)
    fcos = dg_fcos.DGFCOSModel
    built = []

    def small_fcos(**kw):
        built.append(fcos(compute_dtype=torch.float32, **kw))
        return built[-1]

    monkeypatch.setattr(dg_fcos, "DGFCOSModel", small_fcos)
    root = str(tmp_path)
    write_domains(root, [("a", "train"), ("a", "val"), ("i", "val")], n=2)
    sd = fcos_sd(np.random.RandomState(0), num_cls=91)
    pth = os.path.join(root, "fcos_coco.pth")
    torch.save({k: torch.from_numpy(np.atleast_1d(v)) for k, v in sd.items()},
               pth)
    argv = ["--model", "FCOS", "--exp", "non_dg", "--source_domains", "A",
            "--target_domains", "I", "--eval_batch_size", "2",
            "--data_root", root, "--weights_folder", os.path.join(root, "w"),
            "--weights_file", "t", "--torch_weights", pth,
            "--max_epochs", "0"]
    try:
        result = cli.main(argv, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert 0.0 <= result["map_50"] <= 1.0
    got = built[-1].state_dict()
    want = fcos(num_classes=9, num_domains=1, canvas=(64, 128),
                compute_dtype=torch.float32, device="cpu", seed=42)
    init_logits = want.state_dict()["detector.head.cls_logits.weight"].clone()
    stats = W.port_torchvision(want.detector, sd, "FCOS")
    assert stats["dropped_class_dependent"] == ["head.cls_logits"]
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    np.testing.assert_array_equal(
        got["detector.backbone.body.conv1.weight"].numpy(),
        sd["backbone.body.conv1.weight"])
    assert torch.equal(got["detector.head.cls_logits.weight"], init_logits)


@pytest.mark.parametrize("flag,error,match", [
    (["--mesh", "data=3"], ValueError, "needs 3 devices"),
    (["--process_loader"], None, None)],
    ids=["flag0", "flag1"])  # the cases' ids before --mesh was ported
def test_flags_not_in_the_port_raise(tmp_path, small, flag, error, match):
    """Flags that once raised here: `--mesh data=3` on a one-rank world
    still raises; `--process_loader` now runs to its test result, the
    thread loader's (the same batches, so the same training)."""
    if error is not None:
        with pytest.raises(error, match=match):
            cli.main(flag, device="cpu")
        return
    root = str(tmp_path)
    write_domains(root, [("a", "train"), ("b", "train"), ("a", "val"),
                         ("b", "val"), ("i", "val")])
    argv = ["--model", "FCOS", "--exp", "non_dg", "--source_domains", "AB",
            "--target_domains", "I", "--batch_size", "4",
            "--eval_batch_size", "4", "--data_root", root,
            "--max_epochs", "1"]
    results = [cli.main(argv + ["--weights_folder", os.path.join(root, w)]
                        + extra, device="cpu")
               for w, extra in (("p", flag), ("t", []))]
    assert 0.0 <= results[0]["map_50"] <= 1.0
    assert results[0]["map_50"] == results[1]["map_50"]
    np.testing.assert_array_equal(results[0]["map_per_class"],
                                  results[1]["map_per_class"])
