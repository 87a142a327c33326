"""The readings the limits of ``correct`` are set from, in one process:
sound runs of the program on many seeds (the lower readings), the control
(the reference in fp8, one precision below the configurations' bf16, put
in the program's place) and the planted faults of the timed path (the
upper readings).

    python3 portbench/readings.py --workload serve-b128 --seeds 12 --control 3 \
        --faults 3 --seconds 3 --out readings-serve-b128.json

Benchmark runs never run this. Faults, each planted in the timed path:

* serving: ``altered`` (each image's first proposal moved by 0.1 where
  the predict function returns it), ``half`` (only the first half of the
  batch served, the rest returned empty), ``stale`` (the previous batch's
  proposals returned: a step that leaves its state unchanged),
  ``truncated`` (``num_valid`` cut to a sixth, 300 to 50, where it is
  returned), ``nms05`` (the program built with NMS at IoU 0.5 in place of
  the configuration's 0.7);
* training: ``half`` (the step takes the first half of the batch, its loss
  the mean over those rows), ``unchanged`` (the step computes its loss and
  leaves the state as it was).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

SERVE_FAULTS = ("altered", "half", "stale", "truncated", "nms05")
TRAIN_FAULTS = ("half", "unchanged")


def serve_hooks(torch, kind: str, cfg: dict, dev) -> dict:
    """Predict-function wrappers: the control or a fault."""
    if kind == "control":
        from portbench.reference import serve as ref_serve

        params = ref_serve.load_npz(harness.REPO / cfg["weights"], dev)

        def control(_predict):
            def predict(frames):
                boxes, scores = ref_serve.candidates(params, frames.to(dev), cfg, quant="fp8")
                sel = ref_serve.select(boxes, scores, cfg["pre_nms_topn"],
                                       cfg["nms_iou_threshold"], cfg["test_nms_topn"])
                return {k: torch.from_numpy(sel[k]) for k in ("roi_boxes", "roi_scores",
                                                                "num_valid")}
            return predict
        return {"predict": control}
    if kind == "nms05":
        from portbench.drivers.serve import build_program

        return {"predict": lambda _predict: build_program(
            torch, {**cfg, "nms_iou_threshold": 0.5}, dev)[1]}

    def fault(predict):
        last = {}

        def wrapped(frames):
            if kind == "half":
                h = frames.shape[0] // 2
                out = {k: v.clone() for k, v in predict(frames[:h].contiguous()).items()}
                full = {}
                for k, v in out.items():
                    pad = torch.zeros((frames.shape[0] - h,) + tuple(v.shape[1:]), dtype=v.dtype,
                                      device=v.device)
                    full[k] = torch.cat([v, pad])
                return full
            out = {k: v.clone() for k, v in predict(frames).items()}
            if kind == "altered":
                out["roi_boxes"][:, 0, 0] += 0.1
            elif kind == "truncated":
                out["num_valid"] = out["num_valid"] // 6
            elif kind == "stale":
                prev = last.get("out", out)
                last["out"] = out
                return prev
            return out
        return wrapped
    return {"predict": fault}


def train_hooks(torch, kind: str, cfg: dict, dev) -> dict:
    """Train-step wrappers: the control or a fault."""
    if kind == "control":
        from portbench.reference import geometry, nets

        img = cfg["img_size"]
        fm = geometry.feature_map(cfg["backbone"], img)
        anc = torch.from_numpy(geometry.anchors(img, fm)).to(dev)

        def control(_step):
            def step(state, imgs, boxes, labels, flip=None, rand_bits=None):
                model, opt = state.model, state.optimizer
                x, b = geometry.preprocess(imgs.to(dev), img, boxes.to(dev), flip)
                deltas, lab = geometry.targets(anc, b, labels.to(dev), rand_bits,
                                               n_pos=cfg["total_pos_bboxes"],
                                               n_neg=cfg["total_neg_bboxes"])
                opt.zero_grad(set_to_none=True)
                reg, cls = nets.vgg16(dict(model.named_parameters()), x, quant="fp8")
                l_reg, l_cls = geometry.rpn_loss(deltas, lab, reg, cls)
                loss = l_reg + l_cls
                loss.backward()
                opt.step()
                state.step += 1
                return state, {"loss": loss.detach()}
            return step
        return {"step": control}

    def fault(step):
        def wrapped(state, imgs, boxes, labels, flip=None, rand_bits=None):
            if kind == "half":
                h = imgs.shape[0] // 2
                return step(state, imgs[:h], boxes[:h], labels[:h], flip=flip[:h],
                            rand_bits=rand_bits[:h])
            params = [p.detach().clone() for p in state.model.parameters()]
            opt_state = copy.deepcopy(state.optimizer.state_dict())
            state, m = step(state, imgs, boxes, labels, flip=flip, rand_bits=rand_bits)
            with torch.no_grad():
                for p, p0 in zip(state.model.parameters(), params):
                    p.copy_(p0)
            state.optimizer.load_state_dict(opt_state)
            return state, m
        return wrapped
    return {"step": fault}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
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
    faults = {"serve": SERVE_FAULTS, "train": TRAIN_FAULTS}
    plan = [("sound", i) for i in range(args.seeds)]
    plan += [("control", i) for i in range(args.control)]
    plan += [(f, i) for f in faults[wl["driver"]] for i in range(args.faults)]
    plan = [(kind, args.first_seed + 7919 * i) for kind, i in plan]
    out = {"workload": args.workload, "card": harness.power_limit(), "runs": []}
    make_hooks = serve_hooks if wl["driver"] == "serve" else train_hooks
    for kind, seed in plan:
        hooks = None if kind == "sound" else make_hooks(torch, kind, cfg, "cuda")
        torch.cuda.reset_peak_memory_stats()
        rec = driver.run(torch, wl, cfg, seed, args.seconds, False, "cuda", harness.Spans(),
                         hooks)
        ok, _ = harness.judge(rec["numbers"], wl["limits"])
        row = {"kind": kind, "seed": seed, "numbers": rec["numbers"], "correct_now": ok,
               "attempted": rec.get("batches", rec.get("steps"))}
        out["runs"].append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
