"""Serving Swin-B's RPN from host frames: one client in a closed loop hands
``make_predict_fn(model, hp, from_uint8=True)`` a batch of uint8 frames that
lives in pageable host memory, and copies the proposals (boxes, scores,
counts) back to the host before it sends the next batch. The port lays each
frame on the 800 / 1333 canvas, padded to a multiple of 32.

As ``serve_mvit``: the weights are the reference's draw
(``reference/swin.draw_params``) from the configuration's own seed, the
frames ``serve.frame_pool``'s from the run's seed; a sample of the window's
batches, drawn from the seed, is judged against the reference
(``check_levels``) in blocks once the window has closed; a traced run takes
the device, host and program stretches. ``hooks`` may swap the model
(``"model"``) or the predict function (``"predict"``): the benchmark's own
checks plant faults so.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from .. import check_levels, counts, counts_levels, counts_swin, harness, program
from ..reference import swin as ref
from .serve import OUT_KEYS, frame_pool

SWIN_KEYS = ("embed_dim", "window_size", "mlp_ratio", "patch_size", "ln_eps", "fpn_channels",
             "head_convs")


def hyper_params(T, cfg: dict):
    """The configuration as the port's HyperParams."""
    swin = {k: cfg[k] for k in SWIN_KEYS}
    swin.update(depths=tuple(cfg["depths"]), num_heads=tuple(cfg["num_heads"]))
    return T.get_hyper_params(
        cfg["backbone"], swin=swin,
        canvas_rule=(cfg["min_size_test"], cfg["max_size_test"], cfg["size_divisibility"]),
        anchor_scales=cfg["anchor_sizes"], anchor_ratios=cfg["anchor_ratios"],
        level_strides=cfg["strides"], pre_nms_topn=cfg["pre_nms_topk"],
        test_nms_topn=cfg["post_nms_topk"], nms_iou_threshold=cfg["nms_thresh"],
        box_weights=cfg["box_weights"], scale_clamp=cfg["scale_clamp"],
        pixel_mean=cfg["pixel_mean"], pixel_std=cfg["pixel_std"],
        compute_dtype=cfg["compute_dtype"])


def build_program(torch, cfg: dict, dev, model_hook=None):
    """(hp, the predict function, the weights): the served model as users
    build it, its weights the configuration's draw."""
    import tpurpn_torch as T
    from tpurpn_torch.model import to_device

    hp = hyper_params(T, cfg)  # first: a port without this backbone fails here
    model = T.get_model(hp)
    params = ref.draw_params(cfg, cfg["init"]["seed"])
    model.load_state_dict(params)
    model = to_device(model, dev)
    if model_hook is not None:
        model = model_hook(model)
    return hp, T.make_predict_fn(model, hp, from_uint8=True, device=dev), params


def run(torch, wl, cfg, seed, seconds, trace, dev, spans, hooks=None):
    hooks = hooks or {}
    tr = wl["traffic"]
    B, slots = tr["batch"], tr["pool"] // tr["batch"]
    s_pool, s_off, s_sample, _ = harness.seeds(seed)
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    canvas = ref.canvas(tr["raw_h"], tr["raw_w"], cfg)[1]

    hp, predict, params = build_program(torch, cfg, dev, hooks.get("model"))
    predict = hooks.get("predict", lambda f: f)(predict)
    pool = torch.from_numpy(frame_pool(tr, s_pool))
    offset = s_off % slots

    def serve(k):
        s = (k + offset) % slots
        with spans("pb.predict"):
            out = predict(pool[s * B:(s + 1) * B])
        with spans("pb.copyback"):
            return s, {key: out[key].cpu() for key in OUT_KEYS}

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
           "flops_per_image": counts_swin.forward_flops(cfg, canvas)}

    if trace:
        expected = {"proposal_kernel": 1} if cuda else {}
        it, wu = wl["trace"]["iters"], wl["trace"]["warmup"]
        rec["trace"] = harness.trace_stretch(torch, serve, it, wu, spans, expected, sync)
        rec["program"] = program.program_stretch(torch, serve, it, wu, expected, sync)
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    del predict, hp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # judge the sampled batches against the reference
    ch = wl["check"]
    params = {n: t.to(dev) for n, t in params.items()}
    anc_level = ref.anchors(cfg, canvas)[1].to(dev)
    parts, walks = [], []
    for slot, out in sample:
        for a in range(0, B, ch["block"]):
            f = pool[slot * B + a: slot * B + min(B, a + ch["block"])].to(dev)
            boxes, logits, hw, cv = ref.candidates(params, f, cfg)
            sel = ref.select(boxes, logits, hw, cv, cfg)
            served = {key: out[key][a:a + f.shape[0]].numpy() for key in OUT_KEYS}
            parts.append(check_levels.serve_numbers(ref.clip(boxes, hw, cv), logits, anc_level,
                                                    sel, served, cfg["nms_thresh"]))
            walks += [counts_levels.level_walk_counts(kf, lv, cfg["post_nms_topk"])
                      for kf, lv in zip(sel["keep"], sel["level"])]
            del boxes, logits
    rec["numbers"] = check_levels.merge_serve(parts)
    rec["checked_images"] = len(sample) * B
    if trace:
        tests = float(np.mean([w[0] for w in walks])) * B
        visited = float(np.mean([w[1] for w in walks])) * B
        n = sum(h * w for h, w in ref.level_shapes(cfg, canvas)) * len(cfg["anchor_ratios"])
        rec["bounds_ms"] = {
            "proposal": counts.proposal_bound(B, n, cfg["post_nms_topk"], int(tests),
                                              int(visited))[0],
            "swin_attn": counts_swin.attn_bound(B, cfg, canvas)[0]}
    return rec
