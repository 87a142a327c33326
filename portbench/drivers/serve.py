"""Serving from host frames: one client in a closed loop hands
``make_predict_fn(model, hp, fast=True, from_uint8=True)`` a batch of
uint8 frames that lives in pageable host memory, and copies the proposals
(boxes, scores, counts) back to the host before it sends the next batch.

The frames are a pool made on the host from the seed (the native
SyntheticVOC generator); batch k is the pool's slice (k + offset) mod the
slots. A latency runs from the call with the host batch to the proposals
on the host. A sample of the window's batches, drawn from the seed, is
kept and judged against the reference once the window has closed.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from .. import check, counts, harness
from ..reference import geometry
from ..reference import serve as ref_serve

OUT_KEYS = ("roi_boxes", "roi_scores", "num_valid")


def build_program(torch, cfg: dict, dev):
    """The served model as users build it: the weight file into the RPN,
    BatchNorm folded, the fast uint8 entry."""
    import tpurpn_torch as T
    from tpurpn_torch.io_utils import load_keras_h5_weights
    from tpurpn_torch.model import to_device

    hp = T.get_hyper_params(cfg["backbone"], img_size=cfg["img_size"],
                            pre_nms_topn=cfg["pre_nms_topn"], test_nms_topn=cfg["test_nms_topn"],
                            nms_iou_threshold=cfg["nms_iou_threshold"],
                            compute_dtype=cfg["compute_dtype"])
    model, missing = load_keras_h5_weights(str(harness.REPO / cfg["weights"]), T.get_model(hp))
    if missing:
        raise RuntimeError(f"the weight file lacks {missing[:5]}")
    model = T.fold_batch_norm(to_device(model, dev))
    return hp, T.make_predict_fn(model, hp, fast=cfg["fast"], from_uint8=True, device=dev)


def frame_pool(traffic: dict, seed: int) -> np.ndarray:
    from tpurpn_torch.data import SyntheticVOC

    ds = SyntheticVOC(num_samples=traffic["pool"], raw_h=traffic["raw_h"],
                      raw_w=traffic["raw_w"], max_boxes=traffic["max_boxes"], seed=seed)
    return next(ds.batches(traffic["pool"]))[0]


def run(torch, wl, cfg, seed, seconds, trace, dev, spans, hooks=None):
    hooks = hooks or {}
    tr = wl["traffic"]
    B, slots = tr["batch"], tr["pool"] // tr["batch"]
    s_pool, s_off, s_sample, _ = harness.seeds(seed)
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    hp, predict = build_program(torch, cfg, dev)
    predict = hooks.get("predict", lambda f: f)(predict)
    pool = torch.from_numpy(frame_pool(tr, s_pool))
    offset = s_off % slots

    def frames(k):
        s = (k + offset) % slots
        return s, pool[s * B:(s + 1) * B]

    def serve(k):
        slot, f = frames(k)
        with spans("pb.predict"):
            out = predict(f)
        with spans("pb.copyback"):
            return slot, {key: out[key].cpu() for key in OUT_KEYS}

    for k in range(wl["warmup"]):
        serve(k)
    sync()
    gc.collect()

    # the window: a closed loop until ``seconds`` have passed
    keep = max(1, math.ceil(wl["check"]["sample_images"] / B))
    rng = np.random.default_rng(s_sample)
    sample, lat = [], []
    start_epoch = time.time()
    t0 = time.perf_counter()
    t_end = t0
    k = 0
    while t_end - t0 < seconds:
        ts = time.perf_counter()
        slot, out = serve(k)
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        # reservoir sampling of the window's batches, from the seed
        if len(sample) < keep:
            sample.append((slot, out))
        else:
            j = int(rng.integers(0, k + 1))
            if j < keep:
                sample[j] = (slot, out)
        k += 1
    rec = {"images": k * B, "batches": k, "window_s": t_end - t0, "latencies_s": lat,
           "window_start": start_epoch, "chips": 1, "images_per_iter": B,
           "flops_per_image": counts.forward_flops(cfg["backbone"], cfg["img_size"])}

    if trace:
        expected = ({"ir_block_kernel": len(counts.SERVING_STAGE) - 1, "ir_expand_kernel": 1,
                     "proposal_kernel": 1} if cuda else {})
        rec["trace"] = harness.trace_stretch(
            torch, lambda i: serve(i), wl["trace"]["iters"], wl["trace"]["warmup"], spans,
            expected, sync)
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    del predict, hp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # judge the sampled batches against the reference
    ch = wl["check"]
    params = ref_serve.load_npz(harness.REPO / cfg["weights"], dev)
    parts, walks = [], []
    for slot, out in sample:
        for a in range(0, B, ch["block"]):
            f = pool[slot * B + a: slot * B + min(B, a + ch["block"])].to(dev)
            boxes, scores = ref_serve.candidates(params, f, cfg)
            sel = ref_serve.select(boxes, scores, cfg["pre_nms_topn"], cfg["nms_iou_threshold"],
                                   cfg["test_nms_topn"])
            served = {key: out[key][a:a + f.shape[0]].numpy() for key in OUT_KEYS}
            parts.append(check.serve_numbers(boxes, scores, sel, served,
                                             cfg["nms_iou_threshold"]))
            walks += [counts.nms_walk_counts(k, cfg["test_nms_topn"]) for k in sel["keep"]]
    rec["numbers"] = check.merge_serve(parts)
    rec["checked_images"] = len(sample) * B
    if trace:
        S = geometry.feature_map(cfg["backbone"], cfg["img_size"])
        tests = float(np.mean([w[0] for w in walks])) * B
        visited = float(np.mean([w[1] for w in walks])) * B
        n = S * S * len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
        rec["bounds_ms"] = {
            "ir_stage": counts.ir_stage_bound(B, S)[0],
            "proposal": counts.proposal_bound(B, n, cfg["test_nms_topn"], int(tests),
                                              int(visited))[0]}
    return rec

