"""The traced slice: torch.profiler over a few bounded pieces of the
timed path, each inside a span of the benchmark's own
(`cardbench:<part>`), reduced to what the per-layer readers take: each
part's wall, the device operations inside it, the device's busy time (the
union of the operations' intervals) and the idle gaps with what the host
was doing in each."""

import bisect
import math


def _union(spans):
    """Total length of the union of (start, end) intervals."""
    busy, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


def _gaps(spans, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps, reach = [], lo
    for start, end in sorted(spans):
        if start > reach:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


def run(torch, parts, sync, cuda=True):
    """Run `parts` (a list of (name, fn)) under the profiler, one after
    the other, and reduce each to a dict: its fn's return value plus
    wall_s, ops (name, start_us, end_us) of every device operation inside
    it, kernels (their count without copies and fills), busy_s, and
    gaps [(host activity, seconds)].  cuda=False (the tests) traces the
    host alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    infos = {}
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if cuda:
            # The profiler can miss a session's first device records: a
            # marker kernel goes first, and is left out below.
            torch.cuda._sleep(1000)
            sync()
        for name, fn in parts:
            with record_function(f"cardbench:{name}"):
                infos[name] = fn()
                sync()
    events = prof.events()
    host = [ev for ev in events if ev.device_type != DeviceType.CUDA]
    host_names = {ev.name for ev in host}
    device = [ev for ev in events if ev.device_type == DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)
              and ev.name not in host_names and "spin_kernel" not in ev.name]
    windows = {ev.name[len("cardbench:"):]: (ev.time_range.start,
                                             ev.time_range.end)
               for ev in host if ev.name.startswith("cardbench:")}
    inner = sorted(((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in host if not ev.name.startswith("cardbench:")),
                   key=lambda t: t[0])
    starts = [t[0] for t in inner]
    out = {}
    for name, info in infos.items():
        lo, hi = windows[name]
        ops = [(ev.name, ev.time_range.start, ev.time_range.end)
               for ev in device if lo <= ev.time_range.start < hi]
        spans = [(max(a, lo), min(b, hi)) for _, a, b in ops]
        gaps = {}
        for a, b in _gaps(spans, lo, hi):
            what = _host_activity(inner, starts, (a + b) / 2)
            gaps[what] = gaps.get(what, 0.0) + (b - a) / 1e6
        out[name] = dict(
            info, wall_s=(hi - lo) / 1e6, ops=ops,
            kernels=sum(1 for op in ops if not _is_copy(op[0])),
            busy_s=_union(spans) / 1e6,
            gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))
    return out


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


# Host events searched back from a gap for the one covering it.
LOOK_BACK = 256


def _host_activity(inner, starts, t):
    """The name of the innermost host event covering time t (the one that
    started last among those still running), or "python" when the host
    ran no recorded operation then."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - LOOK_BACK), -1):
        start, end, name = inner[j]
        if end >= t:
            return name
    return "python"


def device_ops(part, limit=10):
    """[name, seconds] of the device operations that took most time."""
    total = {}
    for name, a, b in part["ops"]:
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
    rows = sorted(total.items(), key=lambda kv: -kv[1])[:limit]
    return [[name[:160], s] for name, s in rows]
