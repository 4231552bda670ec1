"""The port's harness pieces against the JAX package's.

- `MeanAveragePrecision` equal to JAX's on seeded random detections;
- `ReduceLROnPlateau` and `EarlyStopping` equal to JAX's over one metric
  sequence;
- a checkpoint round trip is exact; a torch file or a pickle of another
  schema is refused (tests/test_torch_checkpoint.py loads the JAX
  package's `.ckpt` and holds the directory store);
- `Trainer.validate` on a small Faster R-CNN with JAX's weights gives the
  mAP@0.5 of JAX's predict and metric on the same batches, within 1e-6.
"""

import pickle

import numpy as np
import jax
import pytest
import torch

from _torch_parity import build_pair
from dgod_tpu.eval import MeanAveragePrecision as JaxMAP
from dgod_tpu.train import optim as j_optim
from dgod_tpu_torch.data import loader as t_loader
from dgod_tpu_torch.data import transforms as T
from dgod_tpu_torch.eval import MeanAveragePrecision
from dgod_tpu_torch.train import optim as t_optim
from dgod_tpu_torch.train.checkpoint import CheckpointStore, make_store
from dgod_tpu_torch.train.harness import Trainer


def _random_image(rng, n_det, n_gt, classes=4):
    gt = rng.uniform(0, 200, (n_gt, 2))
    gt = np.concatenate([gt, gt + rng.uniform(10, 80, (n_gt, 2))], 1)
    # detections: jittered copies of some gt boxes and random boxes
    pick = rng.randint(0, max(n_gt, 1), n_det)
    det = (gt[pick] if n_gt else rng.uniform(0, 200, (n_det, 4))) \
        + rng.randn(n_det, 4) * 6
    return dict(
        pred_boxes=det.astype(np.float32),
        pred_scores=rng.choice([0.3, 0.5, 0.7, 0.9], n_det),  # ties
        pred_labels=rng.randint(1, classes + 1, n_det),
        gt_boxes=gt.astype(np.float32),
        gt_labels=rng.randint(1, classes + 1, n_gt),
        pred_valid=rng.rand(n_det) > 0.2,
        gt_valid=rng.rand(n_gt) > 0.1)


def test_mean_average_precision_matches_jax():
    rng = np.random.RandomState(0)
    got, ref = MeanAveragePrecision(), JaxMAP()
    for i in range(12):
        img = _random_image(rng, rng.randint(0, 30), rng.randint(0, 8))
        for m in (got, ref):
            m.update(**img)
    a, b = got.compute(), ref.compute()
    assert 0 < b["map_50"] < 1
    assert a["map_50"] == b["map_50"]
    np.testing.assert_array_equal(a["map_per_class"], b["map_per_class"])
    np.testing.assert_array_equal(a["classes"], b["classes"])


def test_plateau_and_early_stopping_match_jax():
    seq = [0.1, 0.2, 0.2, 0.2001, 0.19, 0.18, 0.2, 0.2, 0.2, 0.3, 0.29,
           0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]
    got = (t_optim.ReduceLROnPlateau(), t_optim.EarlyStopping())
    ref = (j_optim.ReduceLROnPlateau(), j_optim.EarlyStopping())
    scales, stops = [], []
    for v in seq:
        scales.append((got[0].step(v), ref[0].step(v)))
        stops.append((got[1].step(v), ref[1].step(v)))
    assert all(a == b for a, b in scales + stops)
    assert min(s for s, _ in scales) < 1.0  # the LR was reduced
    assert any(s for s, _ in stops)  # and training would have stopped


def test_checkpoint_round_trip_is_exact(tmp_path):
    rng = torch.Generator().manual_seed(0)
    params = {"a.weight": torch.randn(3, 4, generator=rng),
              "bn.mean": torch.randn(5, generator=rng)}
    opt_state = t_optim.init_opt_state(params, t_optim.OptConfig("adam"))
    opt_state["mu"]["a.weight"].normal_(generator=rng)
    opt_state["count"]["bn.mean"] = 7
    meta = {"val_acc": -float("inf"), "epoch": 3}
    store = make_store(str(tmp_path / "sub" / "m.ckpt"))
    assert not store.exists() and store.load_latest() is None
    store.save(3, params, opt_state, meta)
    assert store.exists()
    got_params, got_state, got_meta = store.load_latest()
    assert got_params.keys() == params.keys()
    for k, v in params.items():
        assert torch.equal(got_params[k], v)
    for k in ("mu", "nu"):
        for name, v in opt_state[k].items():
            assert torch.equal(got_state[k][name], v)
    assert got_state["count"] == opt_state["count"]
    assert got_meta == dict(meta, step=3)


def test_checkpoint_store_refuses_what_it_cannot_read(tmp_path):
    # a torch zip of another schema (a torchvision checkpoint, say)
    path = str(tmp_path / "tv.ckpt")
    torch.save({"state_dict": {"w": torch.ones(3)}}, path)
    with pytest.raises(ValueError, match="not a dgod_tpu_torch checkpoint"):
        CheckpointStore(path).load_latest()
    # pickles of another schema, or of a class the JAX store never writes
    for i, obj in enumerate([{"w": np.ones(3, np.float32)},
                             {"params": b"", "opt_state": {}},
                             {"params": np.ones(3)}]):
        path = str(tmp_path / f"other{i}.ckpt")
        with open(path, "wb") as f:
            pickle.dump(obj, f)
        with pytest.raises(ValueError, match="not a dgod_tpu_torch checkpoint"):
            CheckpointStore(path).load_latest()


class ListDataset:
    def __init__(self, images, boxes, labels):
        self.images, self.boxes, self.labels = images, boxes, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return (self.images[i], self.boxes[i].copy(), self.labels[i].copy(),
                i % 2)


PREDICT_KEYS = ("image", "image_size", "scale_back")


def test_validate_matches_jax_predict_and_metric(tmp_path, monkeypatch):
    monkeypatch.setattr(T, "CANVAS", (128, 256))
    monkeypatch.setattr(T, "TRAIN_SIZE", (120, 240))
    monkeypatch.setattr(T, "MIN_SIZE", 120)
    monkeypatch.setattr(T, "MAX_SIZE", 240)
    monkeypatch.setattr(T, "MIN_AREA", 1.0)
    jm, jp, tm = build_pair(seed=0)
    predict = jax.jit(jm.predict)
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 255, (120, 240, 3)).astype(np.uint8)
              for _ in range(5)]
    empty = ListDataset(images, [np.zeros((0, 4), np.float32)] * 5,
                        [np.zeros(0, np.int32)] * 5)

    def jax_dets(loader):
        out = []
        for batch in loader:
            d = predict(jp, {k: batch[k] for k in PREDICT_KEYS})
            d = {k: np.asarray(v) for k, v in d.items()}
            n = batch.get("num_real", len(batch["image"]))
            out += [{k: v[i] for k, v in d.items()} for i in range(n)]
        return out

    # the ground truth: three of JAX's detections per image, and a box
    # nothing detects
    dets = jax_dets(t_loader.EvalLoader(empty, 2, False, num_workers=2))
    gt_boxes, gt_labels = [], []
    for d in dets:
        keep = np.nonzero(d["valid"])[0][:3]
        gt_boxes.append(np.concatenate([d["boxes"][keep],
                                        [[2, 2, 30, 30]]]).astype(np.float32))
        gt_labels.append(np.append(d["labels"][keep], 2).astype(np.int32))
    data = ListDataset(images, gt_boxes, gt_labels)
    loader = t_loader.EvalLoader(data, 2, False, num_workers=2)

    ref = JaxMAP()
    for d, b, l in zip(jax_dets(loader), gt_boxes, gt_labels):
        ref.update(d["boxes"], d["scores"], d["labels"], b, l,
                   pred_valid=d["valid"])
    ref = ref.compute()["map_50"]
    trainer = Trainer(tm, t_loader.TrainLoader(data, 2, dg=False), loader,
                      ckpt_path=str(tmp_path / "v.ckpt"), device="cpu")
    got = trainer.validate()["map_50"]
    assert 0 < ref < 1
    assert abs(got - ref) <= 1e-6
