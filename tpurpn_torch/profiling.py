"""Tracing, program spans and step timing (port of ``tpurpn/profiling.py``;
SURVEY.md §5, absent in the reference).

* :func:`span` — a named range of host code at a layer boundary of the
  port (``rpn.predict``, ``rpn.stem``, ``rpn.step.backward``, ...). Off,
  the default, it tests one flag and returns a shared null context: no
  stamp, no allocation, no tensor touched, no sync. On, it appends
  ``(name, parent index, start_ns, end_ns)`` to the record, stamped by
  ``time.time_ns()``, the realtime clock on which ``torch.profiler``
  (kineto) stamps host events (``trace_start_ns()`` plus an event's
  relative start), so a span and the launches of the device operations
  inside it share one timeline;
* :func:`recording` — the recorder on for a block; yields the record, in
  memory;
* :func:`trace` — ``torch.profiler`` over the CPU and, when there is one,
  the CUDA device, exported as a Chrome trace (``chrome://tracing``,
  Perfetto) into ``log_dir``, with a ``record_function`` range per span;
* :class:`StepTimer` — chains steps through their carry and synchronises
  once, so the number is seconds per step of the device's work, not of the
  host's enqueueing.

Spans are host code and nest on the thread that opens them (the caller's:
kernels that autograd's device thread launches during ``backward()`` fall
inside the caller's open span by time). Inside a CUDA-graph capture they
record the capture, not the replays, and add no device work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional, Tuple

import torch

# (name, parent index or None, start_ns, end_ns); None while the span is open
SpanRecord = Tuple[str, Optional[int], int, int]


class _Recorder:
    def __init__(self, annotate: bool):
        self.spans: List[Optional[SpanRecord]] = []
        self.open: List[int] = []
        self.annotate = annotate


_recorder: Optional[_Recorder] = None  # the flag: None while the recorder is off
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def _recorded(rec: _Recorder, name: str):
    ann = torch.profiler.record_function(name) if rec.annotate else None
    i = len(rec.spans)
    parent = rec.open[-1] if rec.open else None
    rec.spans.append(None)
    rec.open.append(i)
    start = time.time_ns()
    if ann is not None:  # stamped as it enters and leaves, like this span
        ann.__enter__()
    try:
        yield
    finally:
        rec.spans[i] = (name, parent, start, time.time_ns())
        rec.open.pop()
        if ann is not None:
            ann.__exit__(None, None, None)


def span(name: str):
    """A context manager around one layer's host code: the shared null
    context while the recorder is off, a recorded range while it is on."""
    if _recorder is None:
        return _NULL
    return _recorded(_recorder, name)


@contextlib.contextmanager
def _on(annotate: bool):
    global _recorder
    if _recorder is not None:  # already on: the outer block owns the record
        yield _recorder.spans
        return
    _recorder = _Recorder(annotate)
    try:
        yield _recorder.spans
    finally:
        _recorder = None


def recording():
    """Turn the span recorder on for the block and yield its record: a list
    of ``(name, parent index or None, start_ns, end_ns)``, one entry a span
    in the order the spans opened, filled in as each closes. Nothing is
    written to disk. Inside :func:`trace` or another ``recording()`` it
    yields the record already in use."""
    return _on(annotate=False)


@contextlib.contextmanager
def trace(log_dir: str = "logs/trace"):
    """Profile the block; write ``<log_dir>/trace.json`` at its end. The
    span recorder is on meanwhile, each span a ``record_function`` range, so
    the trace shows the ``rpn.*`` ranges over the work they launched."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, _on(annotate=True):
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(carry):
    if isinstance(carry, torch.Tensor):
        return carry
    if isinstance(carry, dict):
        carry = list(carry.values())
    if isinstance(carry, (list, tuple)):
        for c in carry:
            t = _first_tensor(c)
            if t is not None:
                return t
    return None


def _sync(carry) -> None:
    """Wait for the device work the carry depends on."""
    t = _first_tensor(carry)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    elif t is not None:
        float(t.sum())


class StepTimer:
    """Times chained steps; reports seconds per step with one sync.

    ``step_fn`` takes and returns a carry (a tensor, or a dict / list /
    tuple holding tensors): each step depends on the last through it. The
    first tensor in the carry says which device to wait for.
    """

    def __init__(self, step_fn: Callable, init_carry):
        self.step_fn = step_fn
        self.init_carry = init_carry

    def run(self, iters: int = 10, warmup: int = 1) -> float:
        carry = self.init_carry
        for _ in range(warmup):
            carry = self.step_fn(carry)
        _sync(carry)
        carry = self.init_carry
        t0 = time.perf_counter()
        for _ in range(iters):
            carry = self.step_fn(carry)
        _sync(carry)
        return (time.perf_counter() - t0) / iters
