"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

The same numpy inputs go through a dgod_tpu function (JAX, CPU) and its
dgod_tpu_torch counterpart (torch, CPU). `build_pair` and `build_fcos_pair`
give a small float32 JAX model of each family and its port with the same
weights. Random draws are the JAX model's
own: `jax_draws` re-derives them with the split chain of
dg_frcnn._train_forward (rng -> k_rpn, k_roi) -> faster_rcnn rpn_loss /
select_training_samples (split per image) -> matchers.balanced_sample
(k_pos, k_neg -> uniform priorities), and hands them to the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dgod_tpu.models.dg_fcos import DGFCOSModel as JaxDGFCOS
from dgod_tpu.models.dg_frcnn import DGFRCNNModel as JaxDGFRCNN
from dgod_tpu.models.fcos import FCOSLossConfig as JaxLossConfig
from dgod_tpu.models.faster_rcnn import FRCNNConfig as JaxConfig
from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel, Draws, batch_to_torch
from dgod_tpu_torch.models.fcos import FCOSLossConfig
from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig
from dgod_tpu_torch.utils.weights import load_jax_params

CANVAS = (128, 256)
BLOCKS = (1, 1, 1, 1)
NUM_DOMAINS = 2
MAX_GT = 8
SMALL = dict(
    num_classes=9,
    rpn_pre_nms_train=256, rpn_pre_nms_test=256,
    rpn_post_nms_train=256, rpn_post_nms_test=256,
    rpn_batch_per_image=64,
    box_batch_per_image=64,
)
REG_WEIGHTS = (0.5, 0.5, 0.5, 0.05, 1e-4)


def tiny_batch(b=2, seed=0):
    """The batch of tests/test_dg_frcnn.py, with a third box on image 1."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, MAX_GT, 4), np.float32)
    labels = np.zeros((b, MAX_GT), np.int32)
    valid = np.zeros((b, MAX_GT), bool)
    for i in range(b):
        boxes[i, 0] = [20, 20, 90, 90]
        boxes[i, 1] = [120, 30, 200, 100]
        labels[i, :2] = [1, 3]
        valid[i, :2] = True
    boxes[1, 2] = [60, 70, 250, 125]
    labels[1, 2] = 7
    valid[1, 2] = True
    return {
        "image": rng.randint(0, 255, (b, *CANVAS, 3), np.uint8),
        "boxes": boxes,
        "labels": labels,
        "gt_valid": valid,
        "domain": np.arange(b, dtype=np.int32) % NUM_DOMAINS,
        "image_size": np.tile(np.float32(CANVAS), (b, 1)),
        "scale_back": np.ones((b, 2), np.float32),
    }


def build_pair(seed=0):
    """(JAX model, JAX params, port model with the same weights), f32."""
    jm = JaxDGFRCNN(num_classes=9, num_domains=NUM_DOMAINS, canvas=CANVAS,
                    config=JaxConfig(**SMALL), compute_dtype=jnp.float32,
                    backbone_block_counts=BLOCKS)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = DGFRCNNModel(num_classes=9, num_domains=NUM_DOMAINS, canvas=CANVAS,
                      config=FRCNNConfig(**SMALL), compute_dtype=torch.float32,
                      backbone_block_counts=BLOCKS, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def build_fcos_pair(seed=0, **loss_config):
    """(JAX DG FCOS, its params, the port with the same weights), float32,
    both under the same `FCOSLossConfig(**loss_config)`."""
    jm = JaxDGFCOS(num_classes=9, num_domains=NUM_DOMAINS, canvas=CANVAS,
                   loss_config=JaxLossConfig(**loss_config),
                   compute_dtype=jnp.float32, backbone_block_counts=BLOCKS)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = DGFCOSModel(num_classes=9, num_domains=NUM_DOMAINS, canvas=CANVAS,
                     loss_config=FCOSLossConfig(**loss_config),
                     compute_dtype=torch.float32, backbone_block_counts=BLOCKS,
                     device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def _uniform_pairs(key, batch, n):
    """Per image: k_pos, k_neg = split(key_b); uniform(k, (n,)) each."""
    pos, neg = [], []
    for kb in jax.random.split(key, batch):
        k_pos, k_neg = jax.random.split(kb)
        pos.append(np.asarray(jax.random.uniform(k_pos, (n,))))
        neg.append(np.asarray(jax.random.uniform(k_neg, (n,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


def jax_draws(rng, tm, batch_size, num_gt=MAX_GT) -> Draws:
    """The JAX model's sampling priorities for `loss_for_mode(..., rng)`."""
    k_rpn, k_roi = jax.random.split(rng)
    cfg = tm.config
    n_prop = min(cfg.rpn_post_nms_train,
                 sum(min(cfg.rpn_pre_nms_train, c)
                     for c in tm.detector.anchor_counts))
    R = tm.detector.anchors.shape[0]
    return Draws(*_uniform_pairs(k_rpn, batch_size, R),
                 *_uniform_pairs(k_roi, batch_size, n_prop + num_gt))


def to_torch(batch):
    return batch_to_torch(batch, "cpu")


def jax_name(path) -> str:
    """Port parameter name of a JAX tree path ('kernel' -> 'weight')."""
    keys = [p.key for p in path]
    if keys[-1] == "kernel":
        keys[-1] = "weight"
    return ".".join(keys)
