"""The predict driver: a cell whose traffic has "kind": "predict".

A closed loop with one client, as the reference's serial validation loop
and the CLI's default `--eval_batch_size 1` run it: each request is one
image of a seeded pool, copied host -> pinned -> card as Trainer.validate
places a batch, run through train/steps.py::make_eval_step, and its
detections copied back into pinned host memory as Trainer.validate fetches
them. A request's latency runs from its submission to its detections on
the host; the next request is sent when it is done.

The check: after the window, the plain reference, in the precision the
configuration states, runs each image of the pool itself once: its RPN's
proposals, its decoded box of every label at each of them, and its own
detections. Each distinct answer served in the window is then judged
against that view (compare.detection_numbers): its scores by the reference's
box head at the proposals its boxes were decoded from, its boxes against
the reference's candidates (RPN and K5), and its set against the
reference's detections and greedy suppression (K6). The worst answer
counts."""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from . import compare, models, synthetic
from .common import Spans
from .timing import synchronize
from .train import np_seed

PATH = "predict"


def setup(cell: dict, seed: int, device, spans):
    from dgod_tpu_torch.data.loader import to_tensor
    from dgod_tpu_torch.train import steps
    from dgod_tpu_torch.train.harness import Trainer

    config, traffic = cell["config"], cell["traffic"]
    rng = np.random.RandomState(np_seed(seed))
    gen = synthetic.GENERATORS[traffic["generator"]]
    with spans.span("setup.inputs"):
        pool = gen(rng, traffic["pool"], tuple(config["canvas"]),
                   config["num_domains"], max_gt=traffic["max_gt"])
        requests = [{k: pool[k][j:j + 1] for k in
                     ("image", "image_size", "scale_back")}
                    for j in range(traffic["pool"])]
        order = np.concatenate([rng.permutation(traffic["pool"])
                                for _ in range(traffic["order_rounds"])])
        images = torch.from_numpy(pool["image"]).to(device)
    with spans.span("setup.weights"):
        state = models.make_state(config, seed, device, images)
    del images
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    with spans.span("setup.program"):
        model = models.program_model(config, device)
        models.load_state(model, state)
        eval_step = steps.make_eval_step(model)
    pin = device.type == "cuda"
    fetcher = types.SimpleNamespace(device=device)

    def request(j: int, spans):
        with spans.span("copy_in"):
            placed = {k: to_tensor(v, device, pin=pin)
                      for k, v in requests[j].items()}
        with spans.span("predict"):
            dets = eval_step(placed)
        with spans.span("copy_out"):
            host, done = Trainer._fetch(fetcher, dets)
            if done is not None:
                done.synchronize()
        return host

    s = types.SimpleNamespace(config=config, traffic=traffic, device=device,
                              state=state, requests=requests, order=order,
                              request=request, model=model, answers=[],
                              batch=1, max_gt=traffic["max_gt"])
    with spans.span("setup.warm"):
        for j in range(traffic["pool"]):
            request(j, Spans(False))
        synchronize(device)
    return s


def window(s, seconds: float, spans) -> dict:
    latencies, failed = [], 0
    synchronize(s.device)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        j = int(s.order[i % len(s.order)])
        t = time.perf_counter()
        host = s.request(j, spans)
        latencies.append(time.perf_counter() - t)
        # a copy, so that the pinned buffers go back to the host allocator
        # as Trainer.validate's do once it has read them
        answer = {k: v.numpy().copy() for k, v in host.items()}
        if not all(np.isfinite(answer[k]).all()
                   for k in ("boxes", "scores")):
            failed += 1
        s.answers.append((j, answer))
        i += 1
    synchronize(s.device)
    return {"seconds": time.perf_counter() - t0, "attempted": i,
            "failed": failed, "latencies": latencies, "images": i}


def profiled_units(s, units: int, spans) -> None:
    for i in range(units):
        s.request(int(s.order[i % len(s.order)]), spans)


def release(s) -> None:
    s.model = s.request = None


def reference_detections(config: dict, device, state: dict, requests,
                         fp8: bool = False, dtype=None) -> list:
    """The reference's own detections of each request (host numpy), in the
    precision the configuration states, on fp8 operands (the control) or
    in `dtype` (a witness)."""
    model = reference_model_for(config, device, state, fp8, dtype)
    out = []
    with models.exact_float32(), torch.no_grad():
        for req in requests:
            dets = model.predict(_placed(req, device))
            out.append({k: dets[k].cpu().numpy()
                        for k in ("boxes", "scores", "labels", "valid")})
    return out


def reference_views(config: dict, device, state: dict, requests,
                    answers) -> dict:
    """The reference's view of each image (`reference_view`) with its
    `rescore` of each distinct answer served in `answers` ((image index,
    answer) pairs). -> {(image, answer key): view}."""
    model = reference_model_for(config, device, state, False)
    distinct = {}
    for j, a in answers:
        distinct.setdefault(j, {}).setdefault(answer_key(a), a)
    out = {}
    with models.exact_float32(), torch.no_grad():
        for j, by_key in distinct.items():
            batch = _placed(requests[j], device)
            view = reference_view(model, batch)
            feats = view.pop("feats")
            for key, a in by_key.items():
                out[j, key] = dict(view, rescored=rescore(
                    model, batch, feats, a))
    return out


def reference_view(model, batch: dict) -> dict:
    """One image through the reference's predict, keeping what the check
    reads: `feats` (the FPN levels), `candidates`, the decoded and clipped
    box of every foreground label at every proposal its RPN keeps, scaled
    back as the served boxes are [N, C, 4], and `dets`, its own detections
    (host numpy)."""
    from ..reference.ops import boxes as box_ops

    det = model.detector
    feats, _ = det.features(model.normalize(batch["image"]))
    objectness, deltas = det.rpn_forward(feats)
    proposals, prop_valid, _ = det.generate_proposals(
        objectness, deltas, batch["image_size"], training=False)
    logits, regs = det.box_predictions(det.box_features(feats, proposals))
    dets = det.postprocess(logits, regs, proposals, prop_valid,
                           batch["image_size"], batch["scale_back"])
    B, N = proposals.shape[:2]
    boxes = box_ops.delta_decode(regs.float().reshape(B, N, -1, 4),
                                 proposals[:, :, None, :],
                                 det.config.box_reg_weights)
    size = batch["image_size"].float()
    boxes = box_ops.clip_boxes(boxes, size[:, 0, None, None],
                               size[:, 1, None, None])
    scale = batch["scale_back"].float().flip(-1).repeat(1, 2)
    boxes = boxes[:, :, 1:] * scale[:, None, None, :]
    return {"feats": feats,
            "candidates": boxes[0][prop_valid[0]].cpu().numpy(),
            "dets": {k: dets[k].cpu().numpy()
                     for k in ("boxes", "scores", "labels", "valid")}}


def _placed(req: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in req.items()}


def reference_model_for(config, device, state, fp8, dtype=None):
    model = models.reference_model(config, device, fp8=fp8, dtype=dtype)
    models.load_state(model, state)
    return model


def answer_key(a: dict) -> bytes:
    return b"".join(np.ascontiguousarray(a[k]).tobytes()
                    for k in ("boxes", "scores", "labels", "valid"))


def rescore(model, batch: dict, feats, answer: dict,
            iters: int = 3) -> np.ndarray:
    """The reference's class probability of each served detection's label
    at the proposal it was decoded from, one image. The served box (scaled
    back to the canvas's frame) is `delta_decode(proposal, deltas at the
    proposal)`; the reference finds that proposal by inverting the decode
    with its own deltas, starting from the served box (`iters` rounds:
    the random box predictor's deltas are small, so the fixed point is
    reached at once). NaN for a box clipped to the image's edge. `feats`:
    the image's FPN levels (reference_view)."""
    from ..reference.ops.boxes import BBOX_XFORM_CLIP

    det = model.detector
    wx, wy, ww, wh = det.config.box_reg_weights
    dev = batch["image"].device
    scale = batch["scale_back"].float().flip(-1).repeat(1, 2)  # sx sy sx sy
    served = torch.from_numpy(answer["boxes"]).to(dev).float() / scale[:, None]
    labels = torch.from_numpy(answer["labels"]).to(dev).long()
    bw = served[..., 2] - served[..., 0]
    bh = served[..., 3] - served[..., 1]
    bx = served[..., 0] + 0.5 * bw
    by = served[..., 1] + 0.5 * bh
    proposal = served
    for i in range(iters + 1):
        logits, regs = det.box_predictions(det.box_features(feats, proposal))
        if i == iters:
            break
        d = torch.gather(regs.float().reshape(*labels.shape, -1, 4), 2,
                         labels[..., None, None].expand(*labels.shape, 1, 4)
                         )[..., 0, :]
        w = bw / torch.exp((d[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP))
        h = bh / torch.exp((d[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP))
        cx = bx - d[..., 0] / wx * w
        cy = by - d[..., 1] / wy * h
        proposal = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                                cy + 0.5 * h], -1)
    probs = torch.softmax(logits.float(), -1)
    scores = torch.gather(probs, -1, labels[..., None])[..., 0]
    # a box clipped to the image's edge has lost the decode's extent along
    # that side: it cannot be traced back to its proposal, and is not judged
    size = batch["image_size"].float()  # h, w
    inside = ((served[..., 0] > 0) & (served[..., 1] > 0)
              & (served[..., 2] < size[:, None, 1])
              & (served[..., 3] < size[:, None, 0]))
    return torch.where(inside, scores, torch.nan).cpu().numpy()


def judge(config, device, state, requests, answers) -> dict:
    """The worst of every answer's numbers (compare.detection_numbers)."""
    if not answers:
        return {}
    views = reference_views(config, device, state, requests, answers)
    f = config["frcnn"]
    return compare.worst([compare.detection_numbers(
        a, views[j, answer_key(a)], f["box_score_thresh"],
        f["box_nms_thresh"], f["detections_per_img"]) for j, a in answers])


def check(s) -> dict:
    return judge(s.config, s.device, s.state, s.requests, s.answers)


def end_to_end(w: dict) -> dict:
    from .common import median, percentile

    ms = [x * 1e3 for x in w["latencies"]]
    return {"predict_ms_p50": median(ms), "predict_ms_p95":
            percentile(ms, 95)}
