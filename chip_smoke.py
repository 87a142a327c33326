#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpurpn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--batch 128]

Drives the MobileNetV2 serving path at full width (500x500 images, batch 128,
seeded random weights with perturbed BatchNorm statistics, folded) through
the entry points a user calls, and checks it:

1. builds the port's CUDA kernels from ``tpurpn_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes: the fused IR stage on (B, 32, 32, 64) bf16 at the bf16
   tolerance (rel 0.02 of max(1, |ref|max)), the proposal kernel on decoded
   (B, 9216) candidates bit for bit; then both at edges the main path does
   not reach (odd spatial sizes; score ties, duplicate boxes, fewer
   candidates than topn);
3. runs ``make_predict_fn(fast=True)`` on B bf16 images and
   ``make_predict_fn(fast=True, from_uint8=True)`` on B uint8 375x500
   frames, with every kernel's launch count set to 0 just before each run and
   read just after; checks shapes, finiteness, ``0 <= num_valid <= 300`` and
   that both kernels launched; holds the fast forward against the plain
   folded forward at the bf16 tolerance;
4. times each kernel and its plain version, the stages of the path and both
   end-to-end variants with CUDA events after a warm-up.

Output: the card's name and power limit (``nvidia-smi``), JSON lines of
measurements, one ``{"kernels": [...]}`` line, and last the line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that last line; so it does without a CUDA device, and
outside a checkout of the repository. TF32 is off for matmuls and
convolutions, so f32 plain versions run in full f32.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 outside
# them, HBM3 bandwidth. A bound is the larger of bytes / bandwidth and the
# sum over operand types of operations / peak.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
IOU_OPS = 14  # f32 operations of one IoU test (4 min/max, 4 sub, 3 max, mul, add, div)
TOL_REL = 0.02


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def close_err(got, ref):
    """(max |got - ref|, allowed) at the bf16 tolerance of tests/test_ir_stage.py."""
    got, ref = got.float(), ref.float()
    scale = max(1.0, float(ref.abs().max()))
    err = (got - ref).abs()
    excess = float((err - (TOL_REL * scale + TOL_REL * ref.abs())).max())
    return float(err.max()), excess <= 0.0


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def perturb_batch_norm(model, generator, torch) -> None:
    """Draw BN statistics and affine terms away from identity, so the fold
    does real work."""
    from tpurpn_torch.backbones.mobilenet_v2 import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
                m.bias.copy_(torch.randn(n, generator=generator) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=generator) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=generator) + 0.5)


def ir_stage_bound(x, weights, blocks):
    """(bound_ms, bound_by) of the fused IR stage on input ``x``."""
    B, S = x.shape[0], x.shape[1]
    px = B * S * S
    mm = dw = 0
    for c_in, c_exp, c_out, _ in blocks:
        mm += 2 * px * c_in * c_exp
        if c_out is not None:
            dw += 2 * 9 * px * c_exp
            mm += 2 * px * c_exp * c_out
    c_last = blocks[-1][2] or blocks[-1][1]
    nbytes = (x.numel() * x.element_size() + px * c_last * 2
              + sum(w.numel() * w.element_size() for w in weights))
    t_ops = mm / PEAK_BF16 + dw / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def proposal_bound(torch, boxes, scores, pre, max_output, thr):
    """(bound_ms, bound_by) of top-``pre`` + greedy NMS on these candidates:
    every score is read (the top-k needs all), the boxes the greedy walk
    visits (up to the last keep) are read once, each visited candidate is
    tested against the boxes kept before it, and the outputs are written."""
    from tpurpn_torch.boxes import batched_non_max_suppression
    from tpurpn_torch.kernels.proposal import top_candidates

    B, N = scores.shape
    idx = top_candidates(scores, pre)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    sel, nv = batched_non_max_suppression(
        top_boxes, torch.gather(scores, 1, idx), max_output, thr, presorted=True)
    keep = torch.zeros((B, pre + 1), dtype=torch.int64, device=boxes.device)
    keep.scatter_(1, torch.where(sel >= 0, sel.long(), pre), 1)
    keep = keep[:, :pre]
    full = nv >= max_output
    visited = torch.where(full, sel[:, max_output - 1].long() + 1, pre)
    pos = torch.arange(pre, device=boxes.device)[None]
    kept_before = torch.cumsum(keep, 1) - keep
    tests = int((kept_before * (pos < visited[:, None])).sum())
    nbytes = B * N * 4 + int(visited.sum()) * 16 + B * max_output * 20 + B * 4
    t_ops = tests * IOU_OPS / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_proposals(torch, out, B, topn) -> None:
    boxes, scores, nv = out["roi_boxes"], out["roi_scores"], out["num_valid"]
    require(boxes.shape == (B, topn, 4) and scores.shape == (B, topn)
            and nv.shape == (B,), f"proposal shapes {boxes.shape} {scores.shape} {nv.shape}")
    require(nv.dtype == torch.int32, f"num_valid dtype {nv.dtype}")
    require(bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()),
            "non-finite proposals")
    require(bool(((nv >= 0) & (nv <= topn)).all()), "num_valid out of [0, topn]")
    past = torch.arange(topn, device=nv.device)[None] >= nv[:, None]
    require(not bool(boxes[past].any() or scores[past].any()), "nonzero past num_valid")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the card",
              file=sys.stderr)
        return 2
    from tpurpn_torch import fold_batch_norm, get_hyper_params, get_model, init_model
    from tpurpn_torch.data import preprocess_batch
    from tpurpn_torch.inference import _FUSED_BLOCKS, fast_mobilenet_forward
    from tpurpn_torch.kernels import _build
    from tpurpn_torch.kernels.ir_stage import (
        fused_ir_stage, fused_ir_stage_plain, pack_stage_weights)
    from tpurpn_torch.kernels.proposal import fused_proposals, fused_proposals_plain
    from tpurpn_torch.model import apply_rpn_head, to_device
    from tpurpn_torch.predict import decode_outputs, make_predict_fn
    from tpurpn_torch.anchors import generate_anchors
    from tpurpn_torch.backbones.mobilenet_v2 import relu6

    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "setup", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": False, "tf32_cudnn": False, "seed": args.seed,
          "batch": args.batch})

    # 1. build every kernel of the path, one nvcc per source, in parallel
    t0 = time.perf_counter()
    _build.build(["proposal", "ir_stage"])
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in ("proposal", "ir_stage")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    # the model: seeded random weights, BN statistics perturbed, then folded
    B = args.batch
    hp = get_hyper_params("mobilenet_v2")  # 500x500 -> 32x32x576, 9,216 anchors
    gen = torch.Generator().manual_seed(args.seed)
    model = get_model(hp)
    init_model(model, gen, device="cpu")
    perturb_batch_norm(model, gen, torch)
    folded = fold_batch_norm(to_device(model, dev))
    dgen = torch.Generator(device=dev).manual_seed(args.seed)
    images = torch.rand((B, hp.img_size, hp.img_size, 3), generator=dgen,
                        device=dev).to(torch.bfloat16)
    frames = torch.randint(0, 256, (B, 375, 500, 3), generator=dgen, device=dev,
                           dtype=torch.uint8)
    pre, topn, thr = min(hp.pre_nms_topn, hp.total_anchors), hp.test_nms_topn, hp.nms_iou_threshold

    # 2. each kernel against its plain version at the main path's shapes
    with torch.no_grad():
        feat6 = folded.backbone(images, stop_after_block=6).contiguous()
        weights, blocks = pack_stage_weights(folded.backbone, _FUSED_BLOCKS,
                                             tail_expand="block_13_expand")
        ir_k = fused_ir_stage(feat6, weights, blocks)
        ir_p = fused_ir_stage_plain(feat6, weights, blocks)
        torch.cuda.synchronize()
        require(ir_k.shape == (B, 32, 32, 576) and ir_k.dtype == torch.bfloat16,
                f"IR stage output {ir_k.shape} {ir_k.dtype}")
        ir_err, ir_ok = close_err(ir_k, ir_p)
        require(ir_ok, f"IR stage kernel vs plain: max abs err {ir_err}")

        ref_reg, ref_cls = folded(images)
        anchors = generate_anchors(hp, dev)
        boxes, scores = decode_outputs(anchors, ref_reg, ref_cls, hp)
        pr_k = fused_proposals(boxes, scores, pre, thr, topn)
        pr_p = fused_proposals_plain(boxes, scores, pre, thr, topn)
        torch.cuda.synchronize()
        pr_err = max(float((pr_k[k].float() - pr_p[k].float()).abs().max()) for k in pr_p)
        for k in pr_p:
            require(torch.equal(pr_k[k], pr_p[k]), f"proposal kernel vs plain differ in {k}")
    emit({"phase": "kernel_vs_plain",
          "ir_stage": {"shape": list(feat6.shape), "max_abs_err": ir_err,
                       "tolerance": f"rel {TOL_REL} of max(1, |ref|max)"},
          "proposals": {"B": B, "N": hp.total_anchors, "pre": pre, "topn": topn,
                        "max_abs_err": pr_err, "tolerance": "bit-exact",
                        "num_valid_mean": float(pr_k["num_valid"].float().mean())}})

    # ... and at the edges the main path does not reach: partial row tiles
    # (odd S), score ties, duplicate boxes, fewer candidates than topn
    edges = {}
    with torch.no_grad():
        for S in (9, 17):
            x = torch.rand((3, S, S, 64), generator=dgen, device=dev).to(torch.bfloat16)
            err, ok = close_err(fused_ir_stage(x, weights, blocks),
                                fused_ir_stage_plain(x, weights, blocks))
            require(ok, f"IR stage kernel vs plain at S={S}: max abs err {err}")
            edges[f"ir_stage_S{S}_max_abs_err"] = err
        for case in ("ties", "duplicates", "fewer_than_topn"):
            n = 160 if case == "fewer_than_topn" else 2000
            y1x1 = torch.rand((4, n, 2), generator=dgen, device=dev) * 0.6
            hw = torch.rand((4, n, 2), generator=dgen, device=dev) * 0.38 + 0.02
            cand = torch.cat([y1x1, y1x1 + hw], dim=-1)
            sc = torch.rand((4, n), generator=dgen, device=dev)
            if case == "ties":
                sc = torch.floor(sc * 7) / 7
            if case == "duplicates":  # one box n-1 times and one apart
                cand[:] = torch.tensor([0.1, 0.1, 0.3, 0.3], device=dev)
                cand[:, -1] = torch.tensor([0.6, 0.6, 0.9, 0.9], device=dev)
                sc[:, -1] = 2.0
            k = fused_proposals(cand, sc, min(pre, n), thr, topn)
            p = fused_proposals_plain(cand, sc, min(pre, n), thr, topn)
            for key in p:
                require(torch.equal(k[key], p[key]), f"proposal kernel vs plain, {case}: {key}")
            edges[f"proposals_{case}_num_valid"] = k["num_valid"].tolist()
        require(edges["proposals_duplicates_num_valid"] == [2] * 4,
                "duplicate candidates must leave two proposals an image")
    emit({"phase": "kernel_edge_cases", **edges})

    # 3. the main path, each variant with the counts at 0 just before it
    kernels = {"ir_stage": fused_ir_stage, "proposals": fused_proposals}
    predict = make_predict_fn(folded, hp, fast=True, device=dev)
    predict_u8 = make_predict_fn(folded, hp, fast=True, from_uint8=True, device=dev)
    launches = {}
    for variant, fn, x in (("bf16", predict, images), ("uint8", predict_u8, frames)):
        for k in kernels.values():
            k.launches = 0
        out = fn(x)
        torch.cuda.synchronize()
        launches[variant] = {n: k.launches for n, k in kernels.items()}
        for n, c in launches[variant].items():
            require(c > 0, f"{variant} main path never launched the {n} kernel")
        check_proposals(torch, out, B, topn)
        emit({"phase": f"main_path_{variant}", "launches": launches[variant],
              "num_valid_min": int(out["num_valid"].min()),
              "num_valid_mean": float(out["num_valid"].float().mean())})

    with torch.no_grad():
        fast_reg, fast_cls = fast_mobilenet_forward(folded, images)
        reg_err, reg_ok = close_err(fast_reg, ref_reg)
        cls_err, cls_ok = close_err(fast_cls, ref_cls)
        require(reg_ok and cls_ok and bool(torch.isfinite(fast_reg).all()),
                f"fast forward vs plain folded forward: {reg_err} {cls_err}")
    emit({"phase": "fast_vs_plain_forward", "rpn_reg_max_abs_err": reg_err,
          "rpn_cls_max_abs_err": cls_err, "ref_reg_absmax": float(ref_reg.abs().max()),
          "tolerance": f"rel {TOL_REL} of max(1, |ref|max)"})

    # 4. timing (CUDA events, after warm-up)
    with torch.no_grad():
        ir_ms = time_ms(torch, lambda: fused_ir_stage(feat6, weights, blocks), 20)
        ir_plain_ms = time_ms(torch, lambda: fused_ir_stage_plain(feat6, weights, blocks), 5)
        pr_ms = time_ms(torch, lambda: fused_proposals(boxes, scores, pre, thr, topn), 20)
        pr_plain_ms = time_ms(torch, lambda: fused_proposals_plain(boxes, scores, pre, thr, topn), 3)
        stages = {
            "preprocess_uint8": time_ms(torch, lambda: preprocess_batch(
                frames, torch.zeros((B, 1, 4), device=dev), hp.img_size,
                dtype=torch.bfloat16), 5),
            "prefix_to_block_6": time_ms(
                torch, lambda: folded.backbone(images, stop_after_block=6), 5),
            "pack_stage_weights": time_ms(torch, lambda: pack_stage_weights(
                folded.backbone, _FUSED_BLOCKS, tail_expand="block_13_expand"), 5),
            "ir_stage_kernel": ir_ms,
            "full_backbone_cudnn": time_ms(torch, lambda: folded.backbone(images), 5),
            "head": time_ms(torch, lambda: apply_rpn_head(folded, ir_k), 5),
            "decode": time_ms(torch, lambda: decode_outputs(anchors, ref_reg, ref_cls, hp), 5),
            "proposals_kernel": pr_ms,
        }
        e2e = {}
        for name, fn, x in (
            ("fast_bf16", predict, images),
            ("fast_uint8", predict_u8, frames),
            ("plain_backbone_bf16", make_predict_fn(folded, hp, device=dev), images),
        ):
            ms = time_ms(torch, lambda: fn(x), 5)
            e2e[name] = {"ms_per_batch": ms, "img_per_s": B / ms * 1e3}
        # the prefix layer by layer (cuDNN convs), each on its real input
        bb = folded.backbone
        prefix = [("Conv1", lambda h: relu6(bb.Conv1(h)))] + [
            (n, bb.get_submodule(n)) for n in bb.block_names()[:7]]
        h = images.permute(0, 3, 1, 2)
        prefix_ms = {}
        for name, layer in prefix:
            prefix_ms[name] = time_ms(torch, lambda: layer(h), 5)
            h = layer(h)
    emit({"phase": "stages_ms", "batch": B, **stages})
    emit({"phase": "prefix_layers_ms", "batch": B, **prefix_ms})
    emit({"phase": "end_to_end", "batch": B, "nvidia_smi": smi, **e2e})

    ir_bound, ir_by = ir_stage_bound(feat6, weights, blocks)
    pr_bound, pr_by = proposal_bound(torch, boxes, scores, pre, topn, thr)
    emit({"kernels": [
        {"name": "fused_ir_stage", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/ir_stage.cu",
         "replaces": "tpurpn/kernels/ir_stage_pallas.py:259",
         "launches": launches["bf16"]["ir_stage"],
         "launches_uint8": launches["uint8"]["ir_stage"],
         "max_abs_err": ir_err, "match": "bf16 tolerance", "ms": ir_ms,
         "plain_ms": ir_plain_ms, "bound_ms": ir_bound, "bound_by": ir_by,
         "library_ms": None},
        {"name": "fused_proposals", "route": "cuda",
         "source": "tpurpn_torch/kernels/csrc/proposal.cu",
         "replaces": "tpurpn/kernels/proposal_pallas.py:352",
         "launches": launches["bf16"]["proposals"],
         "launches_uint8": launches["uint8"]["proposals"],
         "max_abs_err": pr_err, "match": "bit-exact", "ms": pr_ms,
         "plain_ms": pr_plain_ms, "bound_ms": pr_bound, "bound_by": pr_by,
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
