"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json; its parameters are
``portbench/workloads/<cell>.json``, its configuration
``portbench/configs/<config>.json`` and its driver
``portbench/drivers/<driver>.py``. With ``--trace 0`` the result holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics; each
metric is read by ``portbench/metrics/<metric>.py`` from the run's record.
The last line of standard output is the JSON result; the numbers that
decide ``correct`` end standard error, each beside its limit. Beside
``setup_s`` the result gives ``compile_s``, the part of set-up spent
loading the cell's kernel libraries (``kernels`` in its workload file),
and ``nvcc_built``, those that nvcc had to build first: a checkout's first
run builds them into ``build/tpurpn_torch/``, later runs only load them.

Exit codes: 0 with a result (correct or not); 1 without a card, or with
fewer cards than the cell asks for; 2 for an unknown cell; 3 when a
forbidden module (JAX, the JAX package) was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

# few host threads: an OpenMP region over every core of a host shared with
# other work runs at the pace of its slowest, preempted thread (the native
# frame generator's), which spread the runs' rates
THREADS = 2
os.environ["OMP_NUM_THREADS"] = str(THREADS)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    if trace:  # every per-layer metric lists its cells
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = harness.ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def result_line(bench: dict, cell: str, wl: dict, rec: dict, trace: bool, chips: int,
                kind: str):
    """(the result's JSON object, the judged numbers) of a driver's record."""
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ok, checks = harness.judge(rec["numbers"], wl["limits"])
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": ok, "attempted": rec.get("batches", rec.get("steps")), "failed": 0,
              "metrics": metrics, "device": device}
    if trace:
        tr = rec["trace"]
        device["busy_s"] = harness.busy_us(tr) / 1e6
        device["window_s"] = harness.window_us(tr) / 1e6
        result["breakdown"] = harness.breakdown(tr)
        result["trace_complete"] = tr["complete"]
    result["card"] = harness.power_limit()
    result["compile_s"] = rec.get("compile_s")
    result["nvcc_built"] = rec.get("nvcc_built")
    result["window"] = harness.window_stats(rec)
    result["checked_images"] = rec.get("checked_images")
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result, checks


def main(argv=None) -> int:
    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}",
              file=sys.stderr)
        return 2
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    chips = cells[args.workload]["chips"]

    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 1
    from portbench.reference import strict_f32

    strict_f32()
    compile_s, built = harness.load_kernels(wl["kernels"])
    driver = importlib.import_module(f"portbench.drivers.{wl['driver']}")
    rec = driver.run(torch, wl, cfg, args.seed, args.seconds, bool(args.trace), "cuda",
                     harness.Spans())
    rec["setup_s"] = rec["window_start"] - t_start
    rec["compile_s"], rec["nvcc_built"] = compile_s, built
    result, checks = result_line(bench, args.workload, wl, rec, bool(args.trace), chips,
                                 torch.cuda.get_device_name(0))
    result["seed"] = args.seed
    result["checks"] = result.pop("checks")

    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['kind']} {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
