"""The port's profiling helpers on the CPU: ``trace`` writes a Chrome trace
of the block, ``StepTimer`` chains steps through their carry and returns
seconds per step (``tpurpn.profiling``'s contract); the span recorder (off:
one shared null context; on: nested, repeated spans on the profiler's
clock) and the span trees of a predict call and a train step."""

import json

import pytest
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


# --- the program's spans ----------------------------------------------------

def test_span_off_is_one_shared_null_context_and_records_nothing(monkeypatch):
    from tpurpn_torch import profiling

    assert profiling.span("rpn.a") is profiling.span("rpn.b")

    def no(*_a, **_k):
        raise AssertionError("a span off stamped, annotated or synced")

    monkeypatch.setattr(profiling.time, "time_ns", no)
    monkeypatch.setattr(torch.profiler, "record_function", no)
    monkeypatch.setattr(torch.cuda, "synchronize", no)
    with profiling.span("rpn.a"):
        with profiling.span("rpn.b"):
            pass
    monkeypatch.undo()
    with profiling.recording() as spans:
        pass
    assert spans == []


def test_span_on_records_nesting_parents_and_repeats():
    from tpurpn_torch.profiling import recording, span

    with recording() as spans:
        with span("rpn.step"):
            for _ in range(2):
                with span("rpn.step.forward"):
                    pass
                with span("rpn.step.backward"):
                    with span("inner"):
                        pass
        with span("rpn.step"):
            pass
    assert [(s[0], s[1]) for s in spans] == [
        ("rpn.step", None), ("rpn.step.forward", 0), ("rpn.step.backward", 0), ("inner", 2),
        ("rpn.step.forward", 0), ("rpn.step.backward", 0), ("inner", 5), ("rpn.step", None)]
    for name, parent, a, b in spans:
        assert a <= b
        if parent is not None:
            assert spans[parent][2] <= a and b <= spans[parent][3]
    # the recorder is off again, and a span raising inside still closes
    assert span("x") is span("y")
    with recording() as spans:
        with pytest.raises(ValueError):
            with span("rpn.predict"):
                raise ValueError
    assert spans[0][0] == "rpn.predict" and spans[0][3] >= spans[0][2]


def test_trace_annotates_spans_on_the_profilers_clock(tmp_path, monkeypatch):
    """A span inside trace() is a record_function range on the recorder's
    clock: its start and end, trace_start_ns() plus the event's relative
    time, follow the recorder's stamps (each is stamped as the range enters
    and leaves), by under 50 us in the median, and the operation inside it
    lies between them; trace.json names it."""
    import statistics

    from tpurpn_torch.profiling import recording, span

    made = []

    class Kept(torch.profiler.profile):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(torch.profiler, "profile", Kept)
    with trace(str(tmp_path / "t")):
        with recording() as spans:  # the trace's own record
            with span("rpn.warm"):  # the first range pays record_function's set-up
                pass
            x = torch.zeros(8)
            for _ in range(10):
                with span("rpn.clock"):
                    torch.neg(x)
    prof = made[0]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name == "rpn.clock"),
                    key=lambda e: e.time_range.start)
    mine = [s for s in spans if s[0] == "rpn.clock"]
    assert len(events) == len(mine) == 10
    starts = [t0 + e.time_range.start * 1e3 - s[2] for e, s in zip(events, mine)]
    ends = [t0 + e.time_range.end * 1e3 - s[3] for e, s in zip(events, mine)]
    assert min(starts) >= 0 and min(ends) >= 0
    assert statistics.median(starts) < 50e3 and statistics.median(ends) < 50e3
    negs = sorted((e for e in prof.events() if e.name == "aten::neg"),
                  key=lambda e: e.time_range.start)
    assert len(negs) == 10
    for e, s in zip(negs, mine):
        assert s[2] <= t0 + e.time_range.start * 1e3 <= t0 + e.time_range.end * 1e3 <= s[3]
    names = {e.get("name") for e in json.loads(
        (tmp_path / "t" / "trace.json").read_text())["traceEvents"]}
    assert {"rpn.warm", "rpn.clock"} <= names


def _mobilenet(img, fold):
    import tpurpn_torch as T

    hp = T.get_hyper_params("mobilenet_v2", img_size=img)
    model = T.init_model(T.get_model(hp), torch.Generator().manual_seed(0), device="cpu")
    return hp, (T.fold_batch_norm(model) if fold else model)


def _tree(spans):
    """Each span as (name, its parent's name), in the order they opened."""
    return [(s[0], None if s[1] is None else spans[s[1]][0]) for s in spans]


@pytest.mark.parametrize("fast", [False, True])
def test_predict_records_its_span_tree(fast):
    import tpurpn_torch as T
    from tpurpn_torch.profiling import recording

    hp, model = _mobilenet(64, fold=fast)
    predict = T.make_predict_fn(model, hp, fast=fast, from_uint8=True, device="cpu")
    raw = torch.randint(0, 256, (2, 48, 64, 3), dtype=torch.uint8)
    off = predict(raw)
    with recording() as spans:
        on = predict(raw)
    for k in off:  # the recorder changes nothing the call computes
        assert torch.equal(off[k], on[k])
    forward = ([("rpn.stem", "rpn.predict"), ("rpn.prefix", "rpn.predict"),
                ("rpn.head", "rpn.predict")] if fast else [("rpn.stem", "rpn.predict")])
    assert _tree(spans) == [("rpn.predict", None), ("rpn.upload", "rpn.predict"), *forward,
                            ("rpn.decode", "rpn.predict"), ("rpn.select", "rpn.predict")]


def _aten_ops(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("aten::")]


def test_spans_add_no_tensor_work():
    """The same tensor operations run with the recorder off and on: a span
    touches no tensor."""
    import tpurpn_torch as T
    from tpurpn_torch.profiling import recording

    hp, model = _mobilenet(64, fold=True)
    predict = T.make_predict_fn(model, hp, fast=True, from_uint8=True, device="cpu")
    raw = torch.randint(0, 256, (2, 48, 64, 3), dtype=torch.uint8)
    predict(raw)
    off = _aten_ops(lambda: predict(raw))

    def on():
        with recording():
            predict(raw)

    assert _aten_ops(on) == off and off


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_records_its_span_tree(grad_accum):
    import tpurpn_torch as T
    from tpurpn_torch.data import SyntheticVOC
    from tpurpn_torch.profiling import recording

    hp = T.get_hyper_params("vgg16", img_size=64, compute_dtype="float32",
                            total_pos_bboxes=16, total_neg_bboxes=16)
    state = T.create_train_state(hp, torch.Generator().manual_seed(0), device="cpu")
    step = T.make_train_step(hp, augment=True, grad_accum=grad_accum)
    imgs, boxes, labels = (torch.from_numpy(a) for a in next(
        SyntheticVOC(num_samples=2, raw_h=50, raw_w=60, seed=1).batches(2)))
    with recording() as spans:
        state, metrics = step(state, imgs, boxes, labels, torch.Generator().manual_seed(1))
    assert torch.isfinite(metrics["loss"])
    phases = [("rpn.step.forward", "rpn.step"), ("rpn.step.backward", "rpn.step")]
    assert _tree(spans) == [("rpn.step", None), *phases * grad_accum,
                            ("rpn.step.update", "rpn.step")]
