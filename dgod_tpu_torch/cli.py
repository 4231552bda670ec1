"""Experiment CLI (port of dgod_tpu/cli.py) — the same flags and
defaults as the JAX package, which are those of the reference
train_driving_dg.py:29-51 (`--model FRCNN|FCOS`, `--exp dg|non_dg`,
`--source_domains`, `--target_domains`, `--weights_folder`,
`--weights_file`, `--reg_weights a b c d e`) and its extras.

Domain letters map to datasets exactly like datasetsFromArguments
(train_driving_dg.py:54-107): a=ACDC, b=BDD10k, c=Cityscapes, i=IDD, with
sequential domain indices in that order. Everything is seeded to 42
(train_driving_dg.py:112-116).

`--backbone vitdet_b` puts ViTDet-B under DG Faster R-CNN in place of
the ResNet-50 FPN. `main` runs on the card; the CPU is reached only
through its `device` keyword (tests). `--torch_weights` warm-starts from
a torchvision checkpoint when no `.ckpt` exists. `--mesh` trains on a
data x model mesh of ranks, one process per card (parallel/), launched as

  torchrun --nproc_per_node 4 train_driving_dg_torch.py --mesh auto ...

with `--batch_size` the batch each node loads, split over its ranks.
`--process_loader` runs the train loader in a child process
(`data/loader.py::ProcessTrainLoader`), its batches copied into pinned
memory on the card.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from .data.dataset import ConcatDataset, DrivingDataset
from .data.loader import EvalLoader, ProcessTrainLoader, TrainLoader
from .device import resolve_device
from .models.backbone import FRCNN_BACKBONES
from .train.harness import Trainer

DOMAIN_SPECS = {
    "a": ("acdc", "data/Annots/acdc_{split}_all.csv", "data/ACDC/rgb_anon/"),
    "b": ("bdd10k", "data/Annots/bdd10k_{split}_all.csv",
          "data/BDD100K/images/10k/{split}/"),
    "c": ("cityscapes", "data/Annots/cityscapes_{split}_all.csv",
          "data/Cityscapes/leftImg8bit/{split}/"),
    "i": ("idd", "data/Annots/idd_{split}_all.csv",
          "data/IDD/leftImg8bit/{split}/"),
}

# flags the port parses but does not run yet, and where they stand
NOT_PORTED = {}


def parser_args(argv=None):
    parser = argparse.ArgumentParser(description="Main Experiments (H100)")
    parser.add_argument("--model", dest="model", default="FRCNN", type=str,
                        help="FRCNN or FCOS")
    parser.add_argument("--exp", dest="exp", default="non_dg", type=str,
                        help="non_dg or dg")
    parser.add_argument("--backbone", default=FRCNN_BACKBONES[0],
                        choices=FRCNN_BACKBONES,
                        help="DG Faster R-CNN's backbone: the ResNet-50 FPN "
                             "or ViTDet-B (window and global attention, "
                             "simple feature pyramid; Adam at lr 1e-4)")
    parser.add_argument("--source_domains", dest="source_domains",
                        default="ABC", type=str)
    parser.add_argument("--target_domains", dest="target_domains",
                        default="I", type=str)
    parser.add_argument("--weights_folder", dest="weights_folder",
                        default="ABC2I", type=str)
    parser.add_argument("--weights_file", dest="weights_file",
                        default="single_source_acdc", type=str)
    parser.add_argument("--reg_weights", nargs=5,
                        metavar=("a", "b", "c", "d", "e"),
                        dest="reg_weights", type=float,
                        default=[0.5, 0.5, 0.5, 0.05, 0.0001])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--eval_batch_size", type=int, default=1,
                        help="reference parity is 1; raise for throughput")
    parser.add_argument("--max_epochs", type=int, default=100)
    parser.add_argument("--data_root", type=str, default=".")
    parser.add_argument("--metrics_path", type=str, default=None,
                        help="JSONL metrics log (train/val)")
    parser.add_argument("--tb_dir", type=str, default=None,
                        help="TensorBoard log dir (the reference's PL "
                             "default logger, train_driving_dg.py:163); "
                             "scalars mirror the JSONL metrics")
    parser.add_argument("--torch_weights", type=str, default=None,
                        help="torchvision .pth checkpoint as the pretrained "
                             "init (COCO fasterrcnn_resnet50_fpn / "
                             "fcos_resnet50_fpn, or an ImageNet resnet50 "
                             "for the backbone); ignored when the .ckpt "
                             "exists")
    parser.add_argument("--warmup_steps", type=int, default=0,
                        help="linear LR warmup; use ~500-1000 when training "
                             "from scratch (the reference warm-starts COCO "
                             "weights so its raw lr needs no warmup)")
    parser.add_argument("--decode_cache_gb", type=float, default=0.0,
                        help="per-train-domain decoded-image RAM cache "
                             "budget (GiB); epochs >= 2 skip the image "
                             "decode")
    parser.add_argument("--reference_quirks", action="store_true",
                        help="make the run reference-EXACT for parity "
                             "studies: FCOS trains the <=1-GT-image "
                             "zero-target branch (reference fcos.py:139-144)"
                             " and the matcher's exact area formula "
                             "(fcos.py:543), and the DG duplicate batch "
                             "re-samples its augmentation instead of "
                             "replaying identical pixels (DGcommon.py:139-"
                             "151), which also disables the fused pair-step "
                             "optimisation")
    parser.add_argument("--mesh", type=str, default=None,
                        help="multi-GPU training over all the ranks of a "
                             "torchrun launch: 'auto' (data parallel), "
                             "'data=N', 'data=N,model=M' or 'model=M' "
                             "(the head layers split over M ranks)")
    parser.add_argument("--process_loader", action="store_true",
                        help="run the train loader in a child process "
                             "(batches through shared memory)")
    return parser.parse_args(argv)


def datasets_from_arguments(source_domains: str, target_domains: str,
                            data_root: str = ".",
                            decode_cache_gb: float = 0.0):
    def build(letters: str, split: str, cache_gb: float = 0.0):
        out, domain_index = [], -1
        for letter in "abci":
            if letter not in letters:
                continue
            domain_index += 1
            _, csv_tpl, root_tpl = DOMAIN_SPECS[letter]
            csv = os.path.join(data_root, csv_tpl.format(split=split))
            root = os.path.join(data_root, root_tpl.format(split=split))
            out.append(DrivingDataset(
                csv, root, domain_index,
                decode_cache_bytes=int(cache_gb * (1 << 30))))
        return out

    tr_datasets = build(source_domains, "train", decode_cache_gb)
    # val sweeps run EVERY epoch over the same images (DGcommon.py:154-166):
    # the decode cache pays off there just as much as in training
    vl_datasets = build(source_domains, "val", decode_cache_gb)
    test_datasets = build(target_domains, "val", decode_cache_gb)
    return (
        ConcatDataset(tr_datasets), tr_datasets,
        ConcatDataset(vl_datasets), ConcatDataset(test_datasets),
    )


def main(argv=None, device=None):
    """Train, validate, checkpoint and test; returns the test metrics.
    `device=None` means the card (raises without CUDA)."""
    args = parser_args(argv)
    if args.backbone != FRCNN_BACKBONES[0] and args.model != "FRCNN":
        raise ValueError(f"--backbone {args.backbone} is DG Faster R-CNN's; "
                         f"{args.model} runs on the ResNet-50 FPN")
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not in dgod_tpu_torch yet (ROADMAP {item})")
    mesh = None
    if args.mesh:
        from .parallel import mesh as mesh_lib, multihost

        # joins the process group before anything touches the card
        multihost.initialize(device=device)
        mesh = mesh_lib.parse_mesh_spec(args.mesh)
    dev = resolve_device(device)
    SEED = 42
    np.random.seed(SEED)
    random.seed(SEED)
    torch.manual_seed(SEED)

    source = args.source_domains.lower()
    target = args.target_domains.lower()
    tr_dataset, tr_datasets, vl_dataset, test_dataset = datasets_from_arguments(
        source, target, args.data_root, args.decode_cache_gb)
    num_domains = len(tr_datasets)

    # multi-node input sharding: each node loads only its slice. Train
    # slices must be equal-sized (unequal per-node batch counts would leave
    # ranks waiting in a collective) -> even split; eval keeps every image
    # (ceil split) and equalises batch counts with dummy padded batches.
    pad_batches = {}
    if mesh is not None and multihost.node_count() > 1:
        from .data.dataset import Subset

        tr_dataset = Subset(
            tr_dataset, *multihost.host_shard_range(len(tr_dataset), True))
        for key, ds in (("val", vl_dataset), ("test", test_dataset)):
            per = -(-len(ds) // multihost.node_count())  # ceil
            pad_batches[key] = -(-per // args.eval_batch_size)
        vl_dataset = Subset(vl_dataset,
                            *multihost.host_shard_range(len(vl_dataset)))
        test_dataset = Subset(test_dataset,
                              *multihost.host_shard_range(len(test_dataset)))

    # the model canvas must match the data pipeline's padded canvas: bind
    # it to the single source of truth instead of a second default
    from .data import transforms as T

    canvas = T.CANVAS
    if args.model == "FRCNN":
        from .models.dg_frcnn import DGFRCNNModel

        model = DGFRCNNModel(num_classes=9, num_domains=num_domains,
                             canvas=canvas, device=dev, seed=SEED,
                             backbone=args.backbone)
        val_resize = False  # raw-size val path (train_driving_dg.py:137-138)
    elif args.model == "FCOS":
        from .models.dg_fcos import DGFCOSModel
        from .models.fcos import FCOSLossConfig

        loss_config = FCOSLossConfig(
            exact_reference_area=args.reference_quirks,
            single_gt_quirk=args.reference_quirks,
        )
        model = DGFCOSModel(num_classes=9, num_domains=num_domains,
                            canvas=canvas, loss_config=loss_config,
                            device=dev, seed=SEED)
        val_resize = True  # Resize(600,1200) val path (train_driving_dg.py:140-142)
    else:
        raise ValueError(args.model)

    dg = args.exp == "dg"
    loader_kw = dict(seed=SEED, resample_replay=args.reference_quirks)
    if args.process_loader:
        train_loader = ProcessTrainLoader(
            tr_dataset, args.batch_size, dg,
            pin_memory=dev.type == "cuda", **loader_kw)
    else:
        train_loader = TrainLoader(tr_dataset, args.batch_size, dg,
                                   **loader_kw)
    val_loader = EvalLoader(vl_dataset, args.eval_batch_size, val_resize,
                            pad_to_batches=pad_batches.get("val"))
    test_loader = EvalLoader(test_dataset, args.eval_batch_size, val_resize,
                             pad_to_batches=pad_batches.get("test"))

    ckpt = os.path.join(args.weights_folder, args.weights_file + ".ckpt")
    trainer = Trainer(
        model, train_loader, val_loader,
        reg_weights=args.reg_weights, dg=dg,
        max_epochs=args.max_epochs, ckpt_path=ckpt, seed=SEED,
        metrics_path=args.metrics_path, tb_dir=args.tb_dir,
        warmup_steps=args.warmup_steps,
        # reference-exact replay re-samples augmentation on the duplicate
        # batch, which the fused pair step cannot reproduce
        fused_pairs=not args.reference_quirks,
        torch_weights=args.torch_weights,
        device=dev,
        mesh=mesh,
    )
    trainer.fit()
    return trainer.test(test_loader)
