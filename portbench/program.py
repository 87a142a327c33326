"""The program stretch: the port's own spans (``tpurpn_torch.profiling``)
beside the device trace, on one clock, and the per-layer readings taken
from them.

``program_stretch`` runs after a driver's two ``harness.trace_stretch``
stretches: ``iters`` iterations of ``body(i)`` after ``warmup`` untraced
ones, under ``torch.profiler`` with CUDA activity alone and under
``profiling.recording()``. It keeps

* ``spans``: the program's spans, ``(name, parent index or None, start_ns,
  end_ns)`` stamped by ``time.time_ns()``;
* ``ops``: every device operation, ``(name, start_ns, end_ns, launch_ns,
  launch_thread)``, its launch being the CUDA runtime event with the same
  correlation id (stamped by the host; None where the trace has none);
* ``window_ns``: the stretch's host window.

kineto stamps host events on the realtime clock that ``time.time_ns()``
reads (``trace_start_ns()`` plus an event's relative start), so a device
operation belongs to the innermost span whose interval holds its launch:
by time, not by thread, since ``backward()``'s kernels are launched from
autograd's thread while the caller's span is open. The device's own
stamps drift from the host's within a stretch (on an H100, by up to 0.7 %:
3.4 ms over half a second), so the stretch puts them on the host's clock
through the launches (``device_clock``): a kernel that an idle device ran
at once started a launch latency after its launch, and no operation
starts before its launch. A device idle gap, on that clock, belongs to
the innermost span the host was in when the gap began, or to no span
(outside the program: the caller's loop, the copy back). Device
milliseconds stay the device's own.

The profiler can lose the first and the last records of a stretch, so it
runs ``warmup`` more iterations on each side of the window, outside the
recorder, and keeps the operations launched inside the window.

Clock self-check: every launch of the kernels in ``expected`` (the port's
own, counted an iteration as in ``trace_stretch``) must fall inside a
top-level span (``rpn.predict``, ``rpn.step``); otherwise, or with other
counts, or without a card or spans, the stretch is incomplete and every
reader here gives None.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .harness import merged

OUTSIDE = "outside"
# idle on the device before a kernel longer than back-to-back launches leave
PROMPT_GAP_NS = 10_000


def _launched_ops(prof) -> list:
    """The profile's device operations, each with its launch."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launch = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.correlation_id():
            launch.setdefault(e.correlation_id(), (e.start_ns(), e.start_thread_id()))
    ops = []
    for e in events:
        if (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                and not e.name().startswith("ProfilerStep")):
            at, tid = launch.get(e.correlation_id(), (None, None))
            ops.append((e.name(), e.start_ns(), e.end_ns(), at, tid))
    return ops


def program_stretch(torch, body: Callable[[int], None], iters: int, warmup: int,
                    expected: Dict[str, int], sync: Callable[[], None], tries: int = 3) -> dict:
    """Trace ``iters`` iterations of ``body(i)`` after ``warmup`` untraced
    ones with the program's spans recorded; retaken, up to ``tries`` times,
    while the counts of ``expected`` launches or the clock self-check fail.
    Without a card the spans are recorded with no profiler (``ops`` None)."""
    from tpurpn_torch import profiling

    recording = getattr(profiling, "recording", None)  # a port without spans has none
    cuda = torch.cuda.is_available()
    pad = warmup if cuda else 0
    i = 0

    def run(n):
        nonlocal i
        for _ in range(n):
            body(i)
            i += 1
        sync()

    for attempt in range(tries):
        run(warmup)
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            tracer = profile(activities=[ProfilerActivity.CUDA])
        else:
            tracer = contextlib.nullcontext()
        with tracer as prof:
            run(pad)
            with (recording() if recording else contextlib.nullcontext([])) as record:
                w0 = time.time_ns()
                run(iters)
                w1 = time.time_ns()
            spans = list(record)
            run(pad)
        stretch = {"iters": iters, "window_ns": (w0, w1), "spans": spans, "ops": None,
                   "attempts": attempt + 1}
        if cuda:
            ops = _launched_ops(prof)
            stretch["ops"] = [o for o in ops if o[3] is not None and w0 <= o[3] <= w1]
            stretch["unlaunched"] = sum(o[3] is None for o in ops)
            stretch["clock"] = device_clock(stretch["ops"])
        stretch.update(self_check(stretch, expected))
        if stretch["complete"] or not cuda or not spans:
            break
    return stretch


def innermost(spans: Sequence[tuple], t: Optional[int],
              order: Optional[Tuple[List[int], List[int]]] = None) -> Optional[int]:
    """Index of the innermost span whose interval [start, end) holds ``t``,
    or None. Spans of one thread nest, so it is the last span to start at
    or before ``t`` or one of its ancestors. ``order`` is ``span_order``'s
    result, when many times are looked up."""
    if t is None or not spans:
        return None
    idx, starts = order or span_order(spans)
    k = bisect.bisect_right(starts, t) - 1
    j = idx[k] if k >= 0 else None
    while j is not None:
        _, parent, a, b = spans[j]
        if a <= t < b:
            return j
        j = parent
    return None


def span_order(spans: Sequence[tuple]) -> Tuple[List[int], List[int]]:
    """The spans' indices by start (ties: the deeper, later opened, last)
    and their starts."""
    idx = sorted(range(len(spans)), key=lambda j: (spans[j][2], j))
    return idx, [spans[j][2] for j in idx]


def root(spans: Sequence[tuple], j: Optional[int]) -> Optional[int]:
    while j is not None and spans[j][1] is not None:
        j = spans[j][1]
    return j


def within(spans: Sequence[tuple], j: Optional[int], name: str) -> bool:
    """True when span ``j`` or one of its ancestors is named ``name``."""
    while j is not None:
        if spans[j][0] == name:
            return True
        j = spans[j][1]
    return False


def attributed(stretch: dict) -> List[Optional[int]]:
    """For each device operation, the innermost span its launch lies in."""
    spans = stretch["spans"]
    order = span_order(spans)
    return [innermost(spans, o[3], order) for o in stretch["ops"]]


def device_clock(ops: Sequence[tuple]) -> List[Tuple[int, int]]:
    """The device's offset from the host's clock, as vertices (device ns,
    device less host ns) of the lower convex hull of start less launch of
    the kernels that an idle device ran at once: those that follow more
    than ``PROMPT_GAP_NS`` of idle on the device, the stream having had
    nothing else to run (a pageable copy waits for its staging, so copies
    are left out). Those start a launch latency after their launch; every
    other operation starts later."""
    low: Dict[int, int] = {}
    busy_until = None
    for o in sorted(ops, key=lambda o: o[1]):
        if ((busy_until is None or o[1] - busy_until > PROMPT_GAP_NS)
                and not o[0].startswith("Memcpy")):
            low[o[1]] = min(low.get(o[1], o[1] - o[3]), o[1] - o[3])
        busy_until = o[2] if busy_until is None else max(busy_until, o[2])
    hull: List[Tuple[int, int]] = []
    for p in sorted(low.items()):
        while len(hull) >= 2 and ((hull[-1][0] - hull[-2][0]) * (p[1] - hull[-2][1])
                                  - (hull[-1][1] - hull[-2][1]) * (p[0] - hull[-2][0])) <= 0:
            hull.pop()
        hull.append(p)
    return hull


def on_host_clock(stretch: dict, t) -> np.ndarray:
    """Device times ``t`` (ns) on the host's clock."""
    t = np.asarray(t, dtype=np.float64)
    clock = stretch.get("clock")
    if not clock:
        return t
    xs, ys = zip(*clock)
    return t - np.interp(t, xs, ys)


def idle_gaps(stretch: dict) -> List[Tuple[int, int, Optional[int]]]:
    """The device's idle gaps in the window on the host's clock, (start_ns,
    end_ns, the innermost span the host was in when the gap began)."""
    spans = stretch["spans"]
    order = span_order(spans)
    w0, w1 = stretch["window_ns"]
    ops = stretch["ops"]
    starts = on_host_clock(stretch, [o[1] for o in ops])
    ends = on_host_clock(stretch, [o[2] for o in ops])
    busy = merged([(int(a), int(b)) for a, b in zip(starts, ends)])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return [(a, b, innermost(spans, a, order)) for a, b in gaps]


def self_ns(spans: Sequence[tuple], j: int) -> int:
    """Span ``j``'s interval less its children's."""
    kids = sum(s[3] - s[2] for s in spans if s[1] == j)
    return spans[j][3] - spans[j][2] - kids


def self_check(stretch: dict, expected: Dict[str, int]) -> dict:
    """``found`` (launches of each expected kernel in the stretch),
    ``outside_roots`` (those whose launch no top-level span holds) and
    ``complete``."""
    ops, spans, n = stretch["ops"], stretch["spans"], stretch["iters"]
    if ops is None or not spans:
        return {"found": None, "outside_roots": None, "complete": False}
    where = attributed(stretch)
    found = {k: 0 for k in expected}
    outside = 0
    for o, j in zip(ops, where):
        for k in expected:
            if k in o[0]:
                found[k] += 1
                outside += root(spans, j) is None
    complete = outside == 0 and all(found[k] == c * n for k, c in expected.items())
    return {"found": found, "outside_roots": outside, "complete": complete}


def stretch_of(rec: dict) -> Optional[dict]:
    """The run's program stretch, if it has a complete one."""
    st = rec.get("program")
    return st if st and st.get("complete") else None


def device_ms(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Device ms an iteration of the operations launched with one of
    ``names`` the innermost span."""
    st = stretch_of(rec)
    if st is None:
        return None
    names = set(names)
    spans = st["spans"]
    ns = sum(o[2] - o[1] for o, j in zip(st["ops"], attributed(st))
             if j is not None and spans[j][0] in names)
    return ns / st["iters"] / 1e6


def ops_in(rec: dict, name: str) -> Optional[float]:
    """Device operations an iteration launched inside span ``name``."""
    st = stretch_of(rec)
    if st is None:
        return None
    spans = st["spans"]
    return sum(within(spans, j, name) for j in attributed(st)) / st["iters"]


def host_ms(rec: dict, name: str, less: Iterable[str] = ()) -> Optional[float]:
    """Host ms an iteration in the spans ``name``, less their children
    named in ``less``."""
    st = stretch_of(rec)
    if st is None:
        return None
    spans, less = st["spans"], set(less)
    ns = sum(s[3] - s[2] for s in spans if s[0] == name)
    ns -= sum(s[3] - s[2] for s in spans
              if s[0] in less and s[1] is not None and spans[s[1]][0] == name)
    return ns / st["iters"] / 1e6


def idle_in(rec: dict, name: str) -> Optional[float]:
    """Device idle ms an iteration whose gap began inside span ``name``."""
    st = stretch_of(rec)
    if st is None:
        return None
    spans = st["spans"]
    ns = sum(b - a for a, b, j in idle_gaps(st) if within(spans, j, name))
    return ns / st["iters"] / 1e6


def summary(rec: dict) -> Optional[dict]:
    """Per span name, an iteration: the device ms and operations launched
    with it innermost, the device idle ms whose gap began in it, and the
    host's self ms (``outside`` for no span); the stretch's operations an
    iteration and the threads that launched them."""
    st = stretch_of(rec)
    if st is None:
        return None
    spans, n = st["spans"], st["iters"]
    out: Dict[str, Dict[str, float]] = {}

    def add(j, key, v):
        row = out.setdefault(OUTSIDE if j is None else spans[j][0],
                             {"device_ms": 0.0, "ops": 0.0, "idle_ms": 0.0, "host_self_ms": 0.0})
        row[key] += v / n

    for o, j in zip(st["ops"], attributed(st)):
        add(j, "device_ms", (o[2] - o[1]) / 1e6)
        add(j, "ops", 1)
    for a, b, j in idle_gaps(st):
        add(j, "idle_ms", (b - a) / 1e6)
    for j in range(len(spans)):
        add(j, "host_self_ms", self_ns(spans, j) / 1e6)
    return {"spans": out, "ops_per_iter": len(st["ops"]) / n,
            "launch_threads": len({o[4] for o in st["ops"] if o[4] is not None})}
