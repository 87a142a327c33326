"""The readings the limits of ``correct`` are set from for MViTv2-B's cell
(``readings_levels.py`` for ViTDet's), in one process: sound runs of the
program on many seeds, the control (the reference in fp8 in the program's
place) and three faults planted in the timed path:

* ``no_rel_pos``: (a) the relative-position tables of every block zeroed;
* ``no_residual_pooling``: (b) the pooled q no longer added to the
  attention's output;
* ``truncated``: (c) ``num_valid`` cut to a sixth (1,000 to 166), as
  ``readings.py`` cuts it.

    python3 portbench/readings_mvit.py --workload serve-mvitv2-b16 --seeds 12 \\
        --control 3 --faults 3 --seconds 3 --out readings-mvit.json

``--kinds`` names the faults to plant (all by default).

Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

FAULTS = ("no_rel_pos", "no_residual_pooling", "truncated")


def hooks(torch, kind: str, cfg: dict, dev) -> dict:
    """Model or predict-function swaps: the control or a fault."""
    if kind == "control":
        from portbench.reference import mvit

        params = {n: t.to(dev) for n, t in mvit.draw_params(cfg, cfg["init"]["seed"]).items()}

        def control(_predict):
            def predict(frames):
                boxes, logits, hw, cv = mvit.candidates(params, frames.to(dev), cfg, quant="fp8")
                sel = mvit.select(boxes, logits, hw, cv, cfg)
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

    from tpurpn_torch.backbones import mvit as port

    def attentions(model):
        return [m for m in model.modules() if isinstance(m, port.PooledAttention)]

    if kind == "no_rel_pos":
        @torch.no_grad()
        def no_rel_pos(model):
            for m in attentions(model):
                m.rel_pos_h.zero_()
                m.rel_pos_w.zero_()
            return model
        return {"model": no_rel_pos}
    if kind == "no_residual_pooling":
        def no_residual(model):
            for m in attentions(model):
                m.residual_pooling = False
            return model
        return {"model": no_residual}
    raise ValueError(f"unknown fault {kind!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--kinds", default=",".join(FAULTS), help="faults to plant, comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_100_000_000)
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
    kinds = args.kinds.split(",") if args.kinds else []
    unknown = set(kinds) - set(FAULTS)
    if unknown:
        ap.error(f"unknown faults {sorted(unknown)}")
    plan = [("sound", i) for i in range(args.seeds)]
    plan += [("control", i) for i in range(args.control)]
    plan += [(f, i) for f in kinds for i in range(args.faults)]
    plan = [(kind, args.first_seed + 7919 * i) for kind, i in plan]
    out = {"workload": args.workload, "card": harness.power_limit(), "runs": []}
    for kind, seed in plan:
        h = None if kind == "sound" else hooks(torch, kind, cfg, "cuda")
        torch.cuda.reset_peak_memory_stats()
        rec = driver.run(torch, wl, cfg, seed, args.seconds, False, "cuda", harness.Spans(), h)
        ok, _ = harness.judge(rec["numbers"], wl["limits"])
        row = {"kind": kind, "seed": seed, "numbers": rec["numbers"], "correct_now": ok,
               "attempted": rec.get("batches"),
               "memory_peak_bytes": rec["memory_peak_bytes"]}
        out["runs"].append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
