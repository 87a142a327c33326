"""Tracing and step timing (port of ``tpurpn/profiling.py``; SURVEY.md §5,
absent in the reference).

* :func:`trace` — ``torch.profiler`` over the CPU and, when there is one,
  the CUDA device, exported as a Chrome trace (``chrome://tracing``,
  Perfetto) into ``log_dir``;
* :class:`StepTimer` — chains steps through their carry and synchronises
  once, so the number is seconds per step of the device's work, not of the
  host's enqueueing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str = "logs/trace"):
    """Profile the block; write ``<log_dir>/trace.json`` at its end."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
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
