"""Spans of a solve: host-second totals in `History.timings`, and ranges in
a torch profiler's trace while one records.

`span(name, key)` marks one phase of the program.

- With a `key`, the phase's host seconds (time.perf_counter) add to
  `timings[key]` of the solve running on this thread.  `solve()` opens
  that scope around one `partial_schur` call; outside it a key adds to
  nothing (an `estimate_interval` pass reads the card but is no solve).
- With a `name`, while a torch profiler records, the phase is also the
  range "arnoldi:<name>" (a record-function, as
  `torch.profiler.record_function` makes), nested under the range open
  around it, so the trace says which phase of the program the host was in
  at each moment, each idle gap of the card included.

With no profiler recording and no solve to add to, a span is one flag
check and a shared no-op context: it never enters a record-function,
which runs through the dispatcher whether or not a profiler records.

The keys, each a phase of the solve in host seconds; a child's phase lies
inside its parent's, so `device - sync_wait` is the expansion's own host
work and `dense - dense_schur - dense_reorder` the dense layer's Python:

    device         the expansion: every Krylov range with its H readback,
                   and the final basis change (method="device": the
                   whole fused solve), waits on the card included
      sync_wait    every device-to-host read inside it
    dense          the host dense restart, and the final sort
      dense_schur    Francis QR, Ritz values and residual estimates
      dense_reorder  the three-way partition, the Hessenberg restore and
                     the final sort
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["KEYS", "solve", "span", "to_numpy"]

KEYS = ("device", "sync_wait", "dense", "dense_schur", "dense_reorder")


class _Scope(threading.local):
    """The timings of the solve running on this thread, or None."""

    totals = None


_SCOPE = _Scope()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Timed:
    """A span with a total: host seconds into totals[key], and the
    profiler range `rng` (or None) around them."""

    __slots__ = ("totals", "key", "rng", "t0")

    def __init__(self, totals, key, rng):
        self.totals, self.key, self.rng = totals, key, rng

    def __enter__(self):
        if self.rng is not None:
            self.rng.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        self.totals[self.key] += time.perf_counter() - self.t0
        if self.rng is not None:
            self.rng.__exit__(*exc)
        return False


def _range(name):
    """A profiler range: torch's C++ record-function context where this
    torch has one, else `torch.profiler.record_function`, whose Python
    wrapper made a traced Krylov step of the 1M-row Laplacian 10-20 %
    slower on an H100's host for two or three ranges a step."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        return torch.profiler.record_function(name)
    return fast(name)


def span(name=None, key=None):
    """A context for one phase: its host seconds into the running solve's
    timings[key] (with a key, inside `solve()`), and the profiler range
    arnoldi:<name> (with a name, while a profiler records)."""
    rng = None
    if name is not None and _profiler._is_profiler_enabled:
        rng = _range("arnoldi:" + name)
    totals = _SCOPE.totals if key is not None else None
    if totals is None:
        return _NOOP if rng is None else rng
    return _Timed(totals, key, rng)


def to_numpy(t):
    """t on the host as a numpy array: one device-to-host read, its wait
    added to the running solve's timings["sync_wait"]."""
    with span(key="sync_wait"):
        return t.cpu().numpy()


@contextlib.contextmanager
def solve():
    """The scope of one solve on this thread: yields its timings, every
    key of KEYS at 0.0, which the spans inside add to; the range
    arnoldi:partial_schur while a profiler records.  The scope around it,
    if any, is restored on exit."""
    timings = dict.fromkeys(KEYS, 0.0)
    saved, _SCOPE.totals = _SCOPE.totals, timings
    try:
        with span("partial_schur"):
            yield timings
    finally:
        _SCOPE.totals = saved
