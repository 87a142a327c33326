"""The traced run's reading: the idle share and the breakdown from a
record, and a traced serving run through the result line on the CPU."""

import copy

import pytest
import torch

from portbench import harness
from portbench import run as pb_run
from portbench.drivers import serve


def record():
    # device stretch: 1,000 us, busy [100, 300) and [250, 600) -> 250 us an
    # iteration, 10 of them in a 5 ms window; host stretch: window [0, 1000),
    # busy [0, 700): one gap, in pb.copyback
    return {"batches": 10, "window_s": 5e-3, "trace": {
        "ops": [("k1(int)", 100.0, 300.0), ("k2", 250.0, 600.0)], "window_us": 1000.0,
        "iters": 2,
        "host": {"ops": [("k1(int)", 0.0, 700.0)], "window_us": (0.0, 1000.0),
                 "spans": [("pb.predict", 0.0, 650.0), ("pb.copyback", 650.0, 1000.0)]}}}


def test_idle_share_and_breakdown():
    rec = record()
    assert harness.busy_us(rec["trace"]) == 500.0
    assert harness.device_idle_pct(rec) == pytest.approx(50.0)
    b = harness.breakdown(rec["trace"])
    assert b["device_ops"] == [["k2", 350e-6], ["k1", 200e-6]]
    assert b["idle_gaps"] == [["pb.copyback", 300e-6]]
    assert harness.device_idle_pct({**rec, "trace": {**rec["trace"], "ops": []}}) is None


def test_traced_serve_run_on_the_cpu():
    wl = copy.deepcopy(harness.workload("serve-b8"))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    cfg["img_size"] = 64
    wl["traffic"].update(batch=2, pool=4, raw_h=48, raw_w=64)
    wl.update(warmup=1, trace={"warmup": 1, "iters": 2})
    wl["check"].update(sample_images=2, block=2)
    rec = serve.run(torch, wl, cfg, 2 ** 31 + 5, 0.2, True, "cpu", harness.Spans())
    rec["setup_s"] = 1.0
    result, _ = pb_run.result_line(harness.benchmark(), "serve-b8", wl, rec, True, 1, "cpu")
    assert result["correct"]
    # no device: no operation to read, so no device metric; spans still name gaps
    assert "serve.device_idle_pct" not in result["metrics"]
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] > 0
    assert {g[0] for g in result["breakdown"]["idle_gaps"]} <= {
        "pb.predict", "pb.copyback", "pb.window"}
    assert result["breakdown"]["idle_gaps"]
