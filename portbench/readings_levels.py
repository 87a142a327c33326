"""The readings the limits of ``correct`` are set from for a configuration
with a feature pyramid (``readings.py`` for the ViTDet cell), in one
process: sound runs of the program on many seeds, the control (the
reference in fp8 in the program's place) and five faults planted in the
timed path:

* ``across``: NMS across levels (the selection given no levels);
* ``global_topk``: one top-k over every level's candidates of as many as
  the levels take together (5,000 at 1,000 a level) in place of the top-k
  of each level;
* ``no_rel_pos``: the relative-position terms dropped from every attention;
* ``pad_masked``: the window blocks' pad tokens masked out of the keys;
* ``truncated``: ``num_valid`` cut to a sixth (1,000 to 166), as
  ``readings.py`` cuts it.

    python3 portbench/readings_levels.py --workload serve-vitdet-b16 --seeds 12 \\
        --control 3 --faults 3 --seconds 3 --out readings-vitdet.json

``--kinds`` names the faults to plant (all by default).

Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

FAULTS = ("across", "global_topk", "no_rel_pos", "pad_masked", "truncated")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _global_topk(torch, fused):
    """``select_levels`` with one top-k of (levels x ``pre_nms_topn``) over
    all candidates, each keeping its own level (image by image: the levels
    differ)."""
    from tpurpn_torch.anchors import level_sizes

    def select(boxes, logits, hp, image_hw, levels, topn):
        ends = torch.cumsum(torch.tensor(level_sizes(hp), device=boxes.device), 0)
        k = len(hp.level_strides) * hp.pre_nms_topn
        idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
        outs = [_one_image(torch, boxes[i:i + 1], logits[i:i + 1], idx[i],
                           torch.bucketize(idx[i], ends, right=True).to(torch.int32), hp,
                           image_hw, topn, fused) for i in range(boxes.shape[0])]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return select


def _one_image(torch, boxes, logits, idx, lev, hp, image_hw, topn, fused):
    cand = boxes[:, idx]
    score = logits[:, idx]
    h, w = image_hw[0] / hp.img_size, image_hw[1] / hp.img_size
    cand = torch.stack([cand[..., 0].clamp(0.0, h), cand[..., 1].clamp(0.0, w),
                        cand[..., 2].clamp(0.0, h), cand[..., 3].clamp(0.0, w)], -1)
    ok = (cand[..., 2] > cand[..., 0]) & (cand[..., 3] > cand[..., 1])
    score = torch.where(ok, score, float("-inf"))
    out = fused(cand, score, idx.numel(), hp.nms_iou_threshold, topn, levels=lev.contiguous())
    valid = torch.arange(topn, device=boxes.device) < out["num_valid"][:, None]
    out["roi_scores"] = torch.where(valid, torch.sigmoid(out["roi_scores"]), 0.0)
    return out


def _masked_core(torch, cfg, orig):
    """``attention_core`` with the window blocks' pad keys masked out."""
    import torch.nn.functional as F

    from tpurpn_torch.backbones import vit

    g, w = cfg["img_size"] // cfg["patch_size"], cfg["window_size"]
    nw = -(-g // w)
    ar = torch.arange(w)
    pad = torch.zeros((nw, nw, w, w), dtype=torch.bool)
    for wy in range(nw):
        for wx in range(nw):
            pad[wy, wx] = (wy * w + ar[:, None] >= g) | (wx * w + ar[None, :] >= g)
    pad = pad.reshape(nw * nw, w * w)

    def core(q, k, v, rel_pos_h, rel_pos_w, side, kind):
        if kind != "window":
            return orig(q, k, v, rel_pos_h, rel_pos_w, side, kind)
        vit._CORE_CALLS[kind] += 1
        n, h, t, d = q.shape
        rq = q.reshape(n, h, side, side, d)
        rel_h = torch.einsum("nhijc,ikc->nhijk", rq, vit.rel_table(rel_pos_h, side).to(q.dtype))
        rel_w = torch.einsum("nhijc,jlc->nhijl", rq, vit.rel_table(rel_pos_w, side).to(q.dtype))
        rel = torch.cat([rel_h, rel_w], -1).reshape(n, h, t, 2 * side)
        bias = torch.matmul(rel, vit.expansion(side, q.device, q.dtype))[..., :t]
        m = pad.to(q.device).repeat(n // pad.shape[0], 1)[:, None, None, :]
        bias = bias.masked_fill(m, float("-inf"))
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    return core


def hooks(torch, kind: str, cfg: dict, dev) -> dict:
    """Predict-function wrappers: the control or a fault."""
    if kind == "control":
        from portbench.reference import vitdet

        params = {n: t.to(dev) for n, t in vitdet.draw_params(cfg, cfg["init"]["seed"]).items()}

        def control(_predict):
            def predict(frames):
                boxes, logits, hw = vitdet.candidates(params, frames.to(dev), cfg, quant="fp8")
                sel = vitdet.select(boxes, logits, hw, cfg)
                return {k: torch.from_numpy(sel[k]) for k in ("roi_boxes", "roi_scores",
                                                                "num_valid")}
            return predict
        return {"predict": control}

    if kind == "truncated":
        def truncate(predict):
            def wrapped(frames):
                out = predict(frames)
                return {**out, "num_valid": out["num_valid"] // 6}
            return wrapped
        return {"predict": truncate}

    import tpurpn_torch.predict as P
    from tpurpn_torch.backbones import vit

    if kind == "across":
        orig = P.fused_proposals
        patch = (P, "fused_proposals", lambda *a, levels=None, **k: orig(*a, **k))
    elif kind == "global_topk":
        patch = (P, "select_levels", _global_topk(torch, P.fused_proposals))
    elif kind == "no_rel_pos":
        orig_core = vit.attention_core
        patch = (vit, "attention_core", lambda q, k, v, rh, rw, side, kind: orig_core(
            q, k, v, torch.zeros_like(rh), torch.zeros_like(rw), side, kind))
    elif kind == "pad_masked":
        patch = (vit, "attention_core", _masked_core(torch, cfg, vit.attention_core))
    else:
        raise ValueError(f"unknown fault {kind!r}")

    def fault(predict):
        def wrapped(frames):
            with _patched(*patch):
                return predict(frames)
        return wrapped
    return {"predict": fault}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--kinds", default=",".join(FAULTS), help="faults to plant, comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from portbench.reference import strict_f32

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 1
    strict_f32()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    driver = importlib.import_module(f"portbench.drivers.{wl['driver']}")
    plan = [("sound", i) for i in range(args.seeds)]
    plan += [("control", i) for i in range(args.control)]
    kinds = args.kinds.split(",") if args.kinds else []
    unknown = set(kinds) - set(FAULTS)
    if unknown:
        ap.error(f"unknown faults {sorted(unknown)}")
    plan += [(f, i) for f in kinds for i in range(args.faults)]
    plan = [(kind, args.first_seed + 7919 * i) for kind, i in plan]
    out = {"workload": args.workload, "card": harness.power_limit(), "runs": []}
    for kind, seed in plan:
        h = None if kind == "sound" else hooks(torch, kind, cfg, "cuda")
        torch.cuda.reset_peak_memory_stats()
        rec = driver.run(torch, wl, cfg, seed, args.seconds, False, "cuda", harness.Spans(), h)
        ok, _ = harness.judge(rec["numbers"], wl["limits"])
        row = {"kind": kind, "seed": seed, "numbers": rec["numbers"], "correct_now": ok,
               "attempted": rec.get("batches")}
        out["runs"].append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
