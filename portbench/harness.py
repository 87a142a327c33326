"""What every driver shares: the cell's files, the seed's streams, host
spans, the traced stretch and its reading, and the device's description.

A traced run runs a driver's loop under ``torch.profiler`` twice, keeps the
events in memory and reduces them here; nothing is written to disk. The
device stretch records CUDA activity alone, so the host runs as it does
untraced but for CUPTI's cost a launch: its device operations (name, start,
end in microseconds) and its length by the host's clock give the per-layer
metrics and the result line's ``busy_s`` and ``window_s``; the idle share
sets its busy time an iteration against the untraced window's.
The host stretch adds CPU activity and the harness spans (``pb.*``, from
``record_function``) and only names the idle gaps of ``breakdown``. The
readers in ``portbench/metrics`` take their numbers from that record.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level modules no process of the benchmark may hold: JAX and the
# JAX package with its TPU-era scripts
FORBIDDEN = ("jax", "jaxlib", "flax", "tpurpn", "benchmarks", "bench", "chip_smoke")
# the port's hand-written kernels, as the profiler names them
PORT_KERNELS = ("ir_block_kernel", "ir_expand_kernel", "proposal_kernel", "nms_kernel",
                "matching_kernel", "targets_kernel")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(ROOT / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules (or of ``names``) that the
    benchmark must not load, compared whole (``tpurpn_torch`` is not
    ``tpurpn``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def process_start() -> float:
    """Epoch seconds at which this process started (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def load_kernels(names: Sequence[str]) -> Tuple[float, List[str]]:
    """Load the port's kernel libraries ``names`` through its own loader,
    which builds with nvcc only those not yet in the checkout's
    ``build/tpurpn_torch/``. Returns (seconds it took, the names built)."""
    from tpurpn_torch.kernels import _build

    t = time.perf_counter()
    built = [n for n in names if not _build.library_path(n).exists()]
    _build.build(names)
    for n in names:
        _build.load(n)
    return time.perf_counter() - t, built


def seeds(seed: int, n: int = 4) -> List[int]:
    """``n`` independent 31-bit seeds from any whole number."""
    return [int(s) & 0x7FFFFFFF for s in np.random.SeedSequence(abs(int(seed))).generate_state(n)]


class Spans:
    """Harness spans: ``record_function`` ranges while a trace runs,
    nothing otherwise."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


def _device_ops(prof, w0: float = float("-inf"), w1: float = float("inf")):
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and not e.name.startswith("ProfilerStep")
            and e.time_range.start >= w0 and e.time_range.end <= w1]


def trace_stretch(torch, body: Callable[[int], None], iters: int, warmup: int,
                  spans: Spans, expected: Dict[str, int], sync: Callable[[], None],
                  tries: int = 3) -> dict:
    """Trace ``iters`` iterations of ``body(i)`` after ``warmup`` untraced
    ones, twice. The device stretch (CUDA activity only) starts and ends
    with the device idle and is timed by the host's clock; ``expected``
    maps a kernel name to its launches an iteration, and a device stretch
    that holds another number of them (the profiler can drop launches) is
    taken again, up to ``tries`` times. The host stretch (CPU and CUDA
    activity, the spans on) follows, for the names of the idle gaps."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    i = 0
    for attempt in range(tries):
        for _ in range(warmup):
            body(i)
            i += 1
        sync()
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                body(i)
                i += 1
            sync()
            t1 = time.perf_counter()
        ops = _device_ops(prof)
        found = {k: sum(1 for o in ops if k in o[0]) for k in expected}
        complete = all(found[k] == n * iters for k, n in expected.items())
        if complete:
            break
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    spans.on = True
    try:
        with profile(activities=acts) as hprof:
            for _ in range(warmup):
                body(i)
                i += 1
            sync()
            with spans("pb.window"):
                for _ in range(iters):
                    body(i)
                    i += 1
                sync()
    finally:
        spans.on = False
    host = [(e.name, e.time_range.start, e.time_range.end) for e in hprof.events()
            if e.name.startswith("pb.")]
    win = [s for s in host if s[0] == "pb.window"]
    w0, w1 = (win[0][1], win[0][2]) if win else (0.0, 0.0)
    return {"ops": ops, "window_us": (t1 - t0) * 1e6, "iters": iters, "found": found,
            "attempts": attempt + 1, "complete": complete,
            "host": {"ops": _device_ops(hprof, w0, w1), "window_us": (w0, w1),
                     "spans": [s for s in host if s[1] >= w0 and s[2] <= w1
                               and s[0] != "pb.window"]}}


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(trace: dict) -> float:
    """Microseconds of the window in which some operation ran on the device."""
    return sum(b - a for a, b in merged([(o[1], o[2]) for o in trace["ops"]]))


def window_us(trace: dict) -> float:
    return trace["window_us"]


def device_idle_pct(rec: dict) -> Optional[float]:
    """100 x the device's idle share of the timed window: 1 - (the device
    stretch's busy time an iteration x the window's iterations) / the
    window's seconds. The busy time is the union of the device operations'
    intervals, from one timeline; the window runs untraced, so the
    profiler's cost on the host (CUPTI's, some microseconds a launch) does
    not count as idle."""
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    n = rec.get("batches", rec.get("steps"))
    return 100.0 * (1.0 - busy_us(tr) / tr["iters"] * n / (rec["window_s"] * 1e6))


def op_ms_per_iter(trace: dict, pred: Callable[[str], bool]) -> float:
    """Device milliseconds an iteration of the operations whose name passes ``pred``."""
    return sum(o[2] - o[1] for o in trace["ops"] if pred(o[0])) / trace["iters"] / 1e3


def short_name(name: str) -> str:
    """A device operation's name without ``void``, anonymous namespaces and
    its parameter list, cut to 160 characters."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i] if i else n
                break
    return n.strip()[:160] or name[:160]


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the device, each named by the innermost harness span the host was
    in when the gap began."""
    by: Dict[str, float] = {}
    for name, a, b in trace["ops"]:
        k = short_name(name)
        by[k] = by.get(k, 0.0) + (b - a) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    host = trace["host"]
    w0, w1 = host["window_us"]
    busy = merged([(o[1], o[2]) for o in host["ops"]])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))

    def where(t0: float) -> str:
        inside = [s for s in host["spans"] if s[1] <= t0 < s[2]]
        return max(inside, key=lambda s: s[1])[0] if inside else "pb.window"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[where(a), (b - a) / 1e6] for a, b in gaps[:top]]}


def power_limit() -> Optional[str]:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def window_stats(rec: dict) -> dict:
    """What the window did, beside the metrics: its length, and the batch
    latencies' quartiles and extremes where it has them."""
    out = {"seconds": rec["window_s"], "images": rec["images"]}
    lat = rec.get("latencies_s")
    if lat:
        q = np.percentile(np.asarray(lat) * 1e3, [0, 25, 50, 75, 100])
        out.update(lat_min_ms=q[0], lat_q1_ms=q[1], lat_p50_ms=q[2], lat_q3_ms=q[3],
                   lat_max_ms=q[4], batches=len(lat))
    return out


def percentile(values: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def judge(numbers: Dict[str, float], limits: Dict[str, list]) -> Tuple[bool, Dict[str, dict]]:
    """Each number beside its limit ``[bound, "max" | "min"]``: a "max"
    number passes at or below its bound, a "min" number at or above it; a
    missing or non-finite number fails."""
    out, ok = {}, True
    for name, (bound, kind) in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and (v <= bound if kind == "max" else v >= bound)
        ok &= bool(good)
        out[name] = {"value": v, "limit": bound, "kind": kind, "ok": bool(good)}
    return ok, out
