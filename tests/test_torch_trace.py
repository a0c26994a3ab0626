"""The port's spans (arnoldimethod_torch/trace.py), on the CPU, over the
host DGKS, low-sync, extended and device methods.

  * Off: with no profiler recording, a solve, `estimate_interval` and
    `rayleigh_ritz` never enter a record-function (torch's C++ context or
    `torch.profiler.record_function`).
  * On: under torch.profiler a solve shows one arnoldi:step a Krylov step
    (a matvec each), one arnoldi:dense_restart a restart, and each range
    inside its parent.
  * Totals: every `History.timings` key, each child within its parent.
  * A traced solve is bitwise the untraced one from the same start.
"""

import bisect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import arnoldimethod_torch as tam
from arnoldimethod_torch import _device, trace
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch.models.operators import FunctionOperator
from arnoldimethod_torch.ops.expansion import LOWSYNC

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


# A few restarts of a small Laplacian: the profiler makes the device
# method's plain restart and the double-word plain ops slow on the CPU.
SOLVE = dict(nev=4, which="SR", tol=1e-8, mindim=8, maxdim=16, restarts=6)

METHODS = {
    "dgks": dict(),
    "lowsync": dict(lowsync=True),
    "extended": dict(extended=True),
    "device": dict(method="device"),
}


def _operator(method):
    # extended: float32 words (float64 words run the double-double dense
    # layer, slow in Python).
    dtype = torch.float32 if method == "extended" else torch.float64
    return tp.laplacian_2d(8, dtype=dtype)


def _v1():
    return np.random.default_rng(5).standard_normal(64)


def _solve(method):
    return tam.partial_schur(_operator(method), v1=_v1(), **SOLVE,
                             **METHODS[method])


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler")


@pytest.fixture
def no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise,
                        raising=False)


def _ranges(prof):
    """{name: sorted [(start, end)]} of the profile's arnoldi:<name>
    events."""
    ranges = {}
    for ev in prof.events():
        if ev.name.startswith("arnoldi:"):
            ranges.setdefault(ev.name[len("arnoldi:"):], []).append(
                (ev.time_range.start, ev.time_range.end))
    for spans in ranges.values():
        spans.sort()
    return ranges


@pytest.fixture(scope="module", params=list(METHODS))
def traced(request):
    """(method, history, its ranges, rollbacks and discarded matvecs
    during the solve) of a solve under the profiler."""
    method = request.param
    rb, disc = LOWSYNC.rollbacks, LOWSYNC.discarded_matvecs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, h = _solve(method)
    return (method, h, _ranges(prof), LOWSYNC.rollbacks - rb,
            LOWSYNC.discarded_matvecs - disc)


def _inside(children, parents):
    """Every (start, end) of `children` lies within one of `parents`."""
    starts = [p[0] for p in parents]
    for start, end in children:
        i = bisect.bisect_right(starts, start) - 1
        if i < 0 or parents[i][1] < end:
            return False
    return True


@pytest.mark.parametrize("method", list(METHODS))
def test_off_solve_never_enters_record_function(method, no_record_function):
    _, h = _solve(method)
    assert h.mvproducts > 0 and h.restarts > 0


def test_off_interval_and_rayleigh_ritz_never_enter_record_function(
        no_record_function):
    A = tp.laplacian_2d(8)
    for which in ("SR", "LM"):
        iv = tam.estimate_interval(A, nev=3, maxdim=12, refine=1,
                                   refine_degree=4, which=which)
        assert iv.a < iv.b
    d, _ = tam.partial_schur(A, v1=_v1(), **SOLVE)
    w, X, res = tam.rayleigh_ritz(A, d.Q)
    assert len(w) == d.Q.shape[1] and X.shape == d.Q.shape


def test_on_one_step_a_matvec(traced):
    method, h, ranges, _, discarded = traced
    # A rolled-back step runs again: its first run's matvec is discarded
    # (none on this smooth operator).
    assert len(ranges["step"]) == h.mvproducts + discarded
    assert len(ranges["matvec"]) == len(ranges["step"])
    assert len(ranges["partial_schur"]) == 1
    assert len(ranges["expand"]) == 1
    assert len(ranges["finish"]) == 1


def test_on_one_dense_restart_a_restart(traced):
    method, h, ranges, rollbacks, _ = traced
    if method == "device":
        # One launch of the restart kernel a restart, one more a rollback;
        # its Schur and reordering phases are inside that launch.
        assert len(ranges["dense_restart"]) == h.restarts + rollbacks
        assert "schur" not in ranges and "reorder" not in ranges
    else:
        assert len(ranges["dense_restart"]) == h.restarts
        assert len(ranges["schur"]) == h.restarts
        # Each restart's partition and restore, and the final sort.
        assert len(ranges["reorder"]) == h.restarts + 1
    # Every restart but the last expands again.
    assert len(ranges["truncate_expand"]) == h.restarts - 1


def test_on_ranges_nest(traced):
    method, _, ranges, _, _ = traced
    assert _inside(ranges["matvec"], ranges["step"])
    assert _inside(ranges["step"], ranges["partial_schur"])
    ranges_of_steps = sorted(ranges["expand"] + ranges["truncate_expand"])
    assert _inside(ranges["step"], ranges_of_steps)
    for name in ("expand", "truncate_expand", "dense_restart", "finish"):
        assert _inside(ranges[name], ranges["partial_schur"])
    if method != "device":
        assert _inside(ranges["schur"], ranges["dense_restart"])
        assert _inside(ranges["reorder"],
                       sorted(ranges["dense_restart"] + ranges["finish"]))


def test_on_ranges_through_record_function(monkeypatch):
    """A torch without the C++ record-function context takes
    torch.profiler.record_function: the same ranges."""
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast",
                        raising=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, h = _solve("dgks")
    ranges = _ranges(prof)
    assert len(ranges["step"]) == len(ranges["matvec"]) == h.mvproducts
    assert len(ranges["dense_restart"]) == h.restarts
    assert _inside(ranges["matvec"], ranges["step"])
    assert _inside(ranges["step"], ranges["partial_schur"])


@pytest.mark.parametrize("method", list(METHODS))
def test_totals_nest(method):
    _, h = _solve(method)
    t = h.timings
    assert set(t) == set(trace.KEYS)
    assert 0 < t["sync_wait"] <= t["device"]
    assert 0 <= t["dense_schur"] and 0 <= t["dense_reorder"]
    assert t["dense_schur"] + t["dense_reorder"] <= t["dense"]
    if method == "device":
        assert t["dense"] == t["dense_schur"] == t["dense_reorder"] == 0.0
    else:
        assert t["dense_schur"] > 0 and t["dense_reorder"] > 0


@pytest.mark.parametrize("method", list(METHODS))
def test_traced_solve_is_bitwise_the_untraced_one(method):
    d0, h0 = _solve(method)
    with profile(activities=[ProfilerActivity.CPU]):
        d1, h1 = _solve(method)
    assert np.array_equal(d0.R, d1.R)
    assert np.array_equal(d0.eigenvalues, d1.eigenvalues)
    assert torch.equal(d0.Q, d1.Q)
    assert (h0.mvproducts, h0.restarts, h0.host_syncs, h0.nconverged) == (
        h1.mvproducts, h1.restarts, h1.host_syncs, h1.nconverged)


@pytest.mark.parametrize("which,bounds", [("SR", 1), ("LM", 2)])
def test_on_interval_ranges(which, bounds):
    A = tp.laplacian_2d(8)
    degrees = (3, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tam.estimate_interval(A, nev=3, maxdim=12, refine_degree=degrees,
                              which=which)
    ranges = _ranges(prof)
    assert len(ranges["interval"]) == 1
    # LM bounds b I - A from above too.
    assert len(ranges["power_bound"]) == bounds
    assert len(ranges["interval_arnoldi"]) == 1
    assert len(ranges["refine"]) == len(degrees)
    assert len(ranges["rayleigh_ritz"]) == len(degrees)
    assert len(ranges["step"]) == 12
    for name in ("power_bound", "interval_arnoldi", "refine"):
        assert _inside(ranges[name], ranges["interval"])
    assert _inside(ranges["step"], ranges["interval_arnoldi"])
    assert _inside(ranges["rayleigh_ritz"], ranges["refine"])
    assert "partial_schur" not in ranges


def test_span_adds_only_inside_a_solve():
    # No profiler and no solve: the shared no-op, whatever is asked.
    assert trace.span("step") is trace.span(key="sync_wait")
    with trace.span("step"), trace.span(key="sync_wait"):
        pass
    with trace.solve() as outer:
        with trace.solve() as inner:
            with trace.span(key="sync_wait"):
                pass
        assert inner["sync_wait"] > 0
        assert outer == dict.fromkeys(trace.KEYS, 0.0)
        with trace.span(key="dense"):
            pass
        assert outer["dense"] > 0
    assert trace.span(key="device") is trace.span("matvec")


def test_solve_scope_is_left_on_an_error():
    with pytest.raises(ValueError):
        with trace.solve():
            raise ValueError
    assert trace.span(key="device") is trace.span()
    # A solve that raises leaves no scope behind either.

    def matvec(x):
        raise ValueError("operator failed")

    op = FunctionOperator(matvec, 64, torch.float64, device="cpu")
    with pytest.raises(ValueError, match="operator failed"):
        tam.partial_schur(op, nev=2)
    assert trace.span(key="device") is trace.span()
