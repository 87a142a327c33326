"""The program stretch's reading (``portbench/program.py``) on synthetic
records: attribution by launch time to the innermost span, idle gaps to
the span the host was in, self time, the clock self-check, the 13 readers;
and the stretch around a serving call on the CPU, which records the port's
spans and gives every reader None."""

import copy
import importlib.util

import pytest
import torch

from portbench import harness, program
from portbench.drivers import serve

READERS = ("serve.stem_ms", "serve.prefix_ms", "serve.head_ms", "serve.select_ms",
           "serve.ops_per_batch", "serve.dispatch_ms", "serve.upload_host_ms",
           "serve.idle_in_predict_ms", "train.forward_ms", "train.backward_ms",
           "train.update_ms", "train.dispatch_ms", "train.idle_in_step_ms")

# two iterations, ns: predict [0, 1000) with upload [0, 100), stem [100, 300),
# select [600, 900); predict [2000, 3000) with upload [2000, 2100); window [0, 3500)
SPANS = [("rpn.predict", None, 0, 1000), ("rpn.upload", 0, 0, 100), ("rpn.stem", 0, 100, 300),
         ("rpn.select", 0, 600, 900), ("rpn.predict", None, 2000, 3000),
         ("rpn.upload", 4, 2000, 2100)]
# (name, start, end, launch, launching thread)
OPS = [("Memcpy HtoD", 50, 150, 10, 1),          # launched in rpn.upload
       ("conv", 150, 400, 120, 1),               # rpn.stem
       ("ir_block_kernel", 400, 500, 350, 1),    # rpn.predict's own
       ("proposal_kernel", 700, 800, 650, 2),    # rpn.select, from another thread
       ("Memcpy DtoH", 1100, 1200, 1050, 1),     # outside the program
       ("late", 3100, 3200, 950, 1),             # launched in rpn.predict, runs later
       ("Memcpy HtoD", 2050, 2150, 2010, 1),     # rpn.upload
       ("ir_block_kernel", 2200, 2300, 2150, 1),
       ("proposal_kernel", 2400, 2500, 2300, 1)]


def stretch(expected=None, **kw):
    st = {"iters": 2, "window_ns": (0, 3500), "spans": list(SPANS), "ops": list(OPS),
          "attempts": 1, **kw}
    st.update(program.self_check(st, expected or {"ir_block_kernel": 1, "proposal_kernel": 1}))
    return st


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", harness.ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_attribution_by_launch_time_to_the_innermost_span():
    st = stretch()
    names = [None if j is None else SPANS[j][0] for j in program.attributed(st)]
    assert names == ["rpn.upload", "rpn.stem", "rpn.predict", "rpn.select", None,
                     "rpn.predict", "rpn.upload", "rpn.predict", "rpn.predict"]
    assert program.innermost(SPANS, 2999) == 4 and program.innermost(SPANS, 3000) is None
    assert program.innermost(SPANS, None) is None and program.innermost([], 5) is None
    # the span that opened later wins a tie of starts
    tie = [("a", None, 0, 10), ("b", 0, 0, 5)]
    assert program.innermost(tie, 0) == 1 and program.innermost(tie, 5) == 0


def test_a_kernel_launched_from_another_thread_belongs_to_the_open_span():
    st = stretch()
    k = next(i for i, o in enumerate(OPS) if o[4] == 2)
    assert SPANS[program.attributed(st)[k]][0] == "rpn.select"
    assert program.within(SPANS, program.attributed(st)[k], "rpn.predict")


def test_idle_gaps_go_to_the_span_the_host_was_in_or_outside():
    gaps = [(a, b, None if j is None else SPANS[j][0]) for a, b, j in program.idle_gaps(stretch())]
    assert gaps == [(0, 50, "rpn.upload"), (500, 700, "rpn.predict"),
                    (800, 1100, "rpn.select"), (1200, 2050, None), (2150, 2200, "rpn.predict"),
                    (2300, 2400, "rpn.predict"), (2500, 3100, "rpn.predict"), (3200, 3500, None)]


def test_device_clock_puts_a_drifting_device_on_the_host_clock():
    """The device's stamps run 1 % slow: the kernels an idle device ran at
    once (after more than 10 us of idle) fix the offset, a queued kernel and
    a pageable copy do not, and an idle gap lands in the span the host was
    in on the host's clock."""
    dev = lambda t: int(t * 0.99)  # noqa: E731
    ops = [("Memcpy HtoD", dev(30_000), dev(40_000), 0, 1),             # staged: late
           ("k0", dev(60_000), dev(80_000), 55_000, 1),                 # prompt
           ("k1", dev(1_000_005), dev(1_400_000), 1_000_000, 1),        # prompt
           ("q", dev(1_402_000), dev(1_510_000), 1_100_000, 1),         # queued behind k1
           ("k2", dev(2_000_005), dev(2_100_000), 2_000_000, 1)]        # prompt
    clock = program.device_clock(ops)
    assert [c[0] for c in clock] == [ops[1][1], ops[2][1], ops[4][1]]
    st = {"iters": 1, "window_ns": (0, 2_200_000), "ops": ops, "clock": clock,
          "spans": [("a", None, 0, 1_500_000), ("b", None, 1_500_000, 2_200_000)]}
    host = program.on_host_clock(st, [o[1] for o in ops])
    assert list(host[[1, 2, 4]]) == [55_000, 1_000_000, 2_000_000]
    assert all(h >= o[3] - 50 for h, o in zip(host, ops))
    # q ends at 1,510,000 on the host's clock, in span b; its raw stamp is in a
    assert dev(1_510_000) < 1_500_000
    gaps = program.idle_gaps(st)
    assert gaps[-2][2] == 1 and abs(gaps[-2][0] - 1_510_000) < 50
    assert [g[2] for g in program.idle_gaps({**st, "clock": []})][-2] == 0


def test_self_time_is_the_interval_less_its_children():
    assert program.self_ns(SPANS, 0) == 1000 - 100 - 200 - 300
    assert program.self_ns(SPANS, 4) == 900 and program.self_ns(SPANS, 2) == 200
    summ = program.summary({"program": stretch()})
    assert summ["spans"]["rpn.predict"]["host_self_ms"] == pytest.approx((400 + 900) / 2 / 1e6)
    assert summ["spans"]["outside"]["ops"] == 0.5 and summ["ops_per_iter"] == 4.5
    assert summ["launch_threads"] == 2


def test_readers_on_a_complete_stretch():
    rec = {"program": stretch()}
    assert rec["program"]["complete"]
    got = {m: reader(m)(rec) for m in READERS}
    ms = 1e-6 / 2  # ns summed over two iterations -> ms an iteration
    assert got["serve.stem_ms"] == pytest.approx(250 * ms)
    assert got["serve.select_ms"] == pytest.approx(100 * ms)
    assert got["serve.prefix_ms"] == 0.0 and got["serve.head_ms"] == 0.0
    assert got["serve.ops_per_batch"] == 4.0
    assert got["serve.dispatch_ms"] == pytest.approx((900 + 900) * ms)
    assert got["serve.upload_host_ms"] == pytest.approx(200 * ms)
    assert got["serve.idle_in_predict_ms"] == pytest.approx((50 + 200 + 300 + 50 + 100 + 600) * ms)
    # no training spans in a serving stretch: zero time in them, no host time
    assert got["train.forward_ms"] == 0.0 and got["train.dispatch_ms"] == 0.0
    assert got["train.idle_in_step_ms"] == 0.0


def test_training_readers():
    spans = [("rpn.step", None, 0, 1000), ("rpn.step.forward", 0, 100, 300),
             ("rpn.step.backward", 0, 300, 800), ("rpn.step.update", 0, 800, 900)]
    ops = [("targets_kernel", 10, 20, 50, 1), ("fwd", 200, 400, 150, 1),
           ("bwd", 400, 900, 350, 7), ("bwd", 900, 1000, 790, 7), ("sgd", 1000, 1050, 850, 1)]
    st = {"iters": 1, "window_ns": (0, 1100), "spans": spans, "ops": ops}
    st.update(program.self_check(st, {"targets_kernel": 1}))
    rec = {"program": st}
    assert [reader(m)(rec) for m in ("train.forward_ms", "train.backward_ms", "train.update_ms",
                                     "train.dispatch_ms", "train.idle_in_step_ms")] == \
        pytest.approx([200e-6, 600e-6, 50e-6, 1000e-6, (10 + 180) * 1e-6])


@pytest.mark.parametrize("case", ["missing", "cpu", "no_spans", "count", "outside_root"])
def test_every_reader_gives_none_on_an_incomplete_or_cpu_stretch(case):
    if case == "missing":
        rec = {}
    elif case == "cpu":
        rec = {"program": stretch(ops=None)}
    elif case == "no_spans":
        rec = {"program": stretch(spans=[])}
    elif case == "count":  # the profiler dropped a launch
        rec = {"program": stretch(expected={"ir_block_kernel": 2, "proposal_kernel": 1})}
    else:  # a port kernel launched outside every top-level span: clocks disagree
        ops = OPS[:-1] + [("proposal_kernel", 3300, 3400, 3250, 1)]
        rec = {"program": stretch(ops=ops)}
        assert rec["program"]["outside_roots"] == 1
    assert not rec.get("program", {}).get("complete")
    assert [reader(m)(rec) for m in READERS] == [None] * len(READERS)
    assert program.summary(rec) is None


def test_program_stretch_records_the_ports_spans_on_the_cpu():
    """The stretch around the serving cell's body on the CPU: no profiler,
    so no operations and every reader None, but the spans of each call."""
    wl = copy.deepcopy(harness.workload("serve-b8"))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    cfg["img_size"] = 64
    _, predict = serve.build_program(torch, cfg, "cpu")
    frames = torch.randint(0, 256, (2, 48, 64, 3), dtype=torch.uint8)
    calls = []

    def body(i):
        calls.append(i)
        out = predict(frames)
        return {k: out[k].cpu() for k in serve.OUT_KEYS}

    st = program.program_stretch(torch, body, 2, 1, {}, lambda: None)
    assert calls == [0, 1, 2] and st["ops"] is None and not st["complete"]
    roots = [s for s in st["spans"] if s[1] is None]
    assert [s[0] for s in roots] == ["rpn.predict"] * 2
    names = {s[0] for s in st["spans"]}
    assert names == {"rpn.predict", "rpn.upload", "rpn.stem", "rpn.prefix", "rpn.head",
                     "rpn.decode", "rpn.select"}
    w0, w1 = st["window_ns"]
    assert all(w0 <= s[2] <= s[3] <= w1 for s in st["spans"])
    assert [reader(m)({"program": st}) for m in READERS] == [None] * len(READERS)
