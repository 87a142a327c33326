"""The port's profiling helpers on the CPU: ``trace`` writes a Chrome trace
of the block, ``StepTimer`` chains steps through their carry and returns
seconds per step (``tpurpn.profiling``'s contract)."""

import json

import torch

from tpurpn_torch.profiling import StepTimer, trace


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "t") and any("mm" in e.get("name", "") for e in events)


def test_step_timer_chains_the_carry():
    calls = []

    def step(carry):
        calls.append(float(carry["x"]))
        return {"x": carry["x"] + 1, "n": [carry["x"]]}

    sec = StepTimer(step, {"x": torch.zeros(())}).run(iters=4, warmup=2)
    assert sec > 0
    # warm-up from the initial carry, then the timed steps from it again
    assert calls == [0.0, 1.0, 0.0, 1.0, 2.0, 3.0]
