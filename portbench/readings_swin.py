"""The readings the limits of ``correct`` are set from for Swin-B's cell
(``readings_mvit.py`` for MViTv2-B's), in one process: sound runs of the
program on many seeds, the control (the reference in fp8 in the program's
place) and four faults planted in the timed path:

* ``no_shift``: (a) no cyclic shift, every block unshifted;
* ``unmasked``: (b) the shifted blocks rolled but not masked;
* ``no_bias``: (c) the relative-position bias tables of every block
  zeroed;
* ``truncated``: (d) ``num_valid`` cut to a sixth (1,000 to 166), as
  ``readings.py`` cuts it.

    python3 portbench/readings_swin.py --workload serve-swin-b16 --seeds 12 \\
        --control 3 --faults 3 --seconds 3 --out readings-swin.json

``--kinds`` names the faults to plant (all by default).

Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

FAULTS = ("no_shift", "unmasked", "no_bias", "truncated")


def hooks(torch, kind: str, cfg: dict, dev) -> dict:
    """Model or predict-function swaps: the control or a fault."""
    if kind == "control":
        from portbench.reference import swin

        params = {n: t.to(dev) for n, t in swin.draw_params(cfg, cfg["init"]["seed"]).items()}

        def control(_predict):
            def predict(frames):
                boxes, logits, hw, cv = swin.candidates(params, frames.to(dev), cfg, quant="fp8")
                sel = swin.select(boxes, logits, hw, cv, cfg)
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

    from tpurpn_torch.backbones import swin as port

    def modules(model, cls):
        return [m for m in model.modules() if isinstance(m, cls)]

    if kind == "no_shift":
        def no_shift(model):
            for blk in modules(model, port.SwinBlock):
                blk.shift = 0
            return model
        return {"model": no_shift}
    if kind == "unmasked":
        def unmasked(model):
            for attn in modules(model, port.WindowAttention):
                forward = attn.forward  # the grid names the mask: pass none
                attn.forward = types.MethodType(lambda self, x, grid, f=forward: f(x, None), attn)
            return model
        return {"model": unmasked}
    if kind == "no_bias":
        @torch.no_grad()
        def no_bias(model):
            for attn in modules(model, port.WindowAttention):
                attn.relative_position_bias_table.zero_()
            return model
        return {"model": no_bias}
    raise ValueError(f"unknown fault {kind!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--kinds", default=",".join(FAULTS), help="faults to plant, comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_200_000_000)
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
