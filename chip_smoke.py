#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printed as one JSON line:

  device   the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc build of the stencil kernel, g++ build of the dense core
  kernel   the CUDA stencil kernel against its plain PyTorch version on the
           card, at five grids: max |difference| against
           8 * eps * sum|coeff| * max|x|; both device times per call (a
           CUDA graph of 20 calls, median of 10 replays) with the effective
           GB/s, and both per-call times with host overhead (CUDA events
           around single calls, median of 30)
  small    a 1,024-row float64 stencil solve on the card against the same
           solve on the CPU (plain stencil): same matvec count, eigenvalues
  readme   laplacian_1d(100), nev=10, :SR, tol=1e-6, float32 (DIA, no kernel)
  main     the 1,048,576-row 2-D Laplacian stencil, nev=20, :SR, tol=1e-6,
           mindim=40, maxdim=80, restarts=400, float32: converged 20/20,
           smallest eigenvalue, Schur residual with the plain stencil, and
           the kernel's launch count against the matvec count
  eigen    partial_eigen on that result: every eigenpair residual
  profile  torch.profiler over the first restarts of the main solve:
           device time by kernel and the device's busy share

Then the card's nvidia-smi line, the kernel summary line and, last, the
result line.  Any failed check ends the run with a non-zero exit code and
no result line; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(phase, ok, **info):
    """Print the phase's line; stop the run if its check failed."""
    emit({"phase": phase, "ok": bool(ok), **info})
    if not ok:
        sys.exit(f"chip_smoke: phase {phase!r} failed")


def median_ms(fn, reps=30, warm=5):
    """Per-call time with CUDA events around each call, median of `reps`
    warm calls: the device time plus whatever host time the call keeps
    the device waiting (launch overhead shows here)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(fn, calls=20, reps=10):
    """Device time per call: `calls` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events; median replay / calls.
    Host launch overhead is out of the picture."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


LAPLACE = tuple(0.130 * c for c in (4.0, -1.0, -1.0, -1.0, -1.0))
# convection_diffusion_2d coefficients (peclet=10) at nx=512.
_BETA = 10.0 * (1.0 / 513) / 2.0
CONV = (4.0, -1.0 - _BETA, -1.0 + _BETA, -1.0, -1.0)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip()
    check("device", smi.returncode == 0 and card,
          nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
          name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          python=sys.version.split()[0])
    return card


def phase_build():
    from arnoldimethod_torch._build import BUILD_DIR
    from arnoldimethod_torch.dense import native
    from arnoldimethod_torch.ops import stencil

    # Libraries already built by an earlier run are loaded, not rebuilt;
    # then the times below are load times.
    prebuilt = sorted(p.name for p in BUILD_DIR.glob("*.so"))
    t0 = time.perf_counter()
    stencil.KERNEL.load()
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_ok = native.available()
    gxx_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in stencil.KERNEL.build_log.splitlines()
             if "registers" in line or "spill" in line]
    check("build", True, nvcc_s=nvcc_s, gxx_s=gxx_s, prebuilt=prebuilt,
          native=native_ok, native_error=native.build_error, ptxas=ptxas)


def phase_kernel(torch):
    from arnoldimethod_torch.ops import stencil

    cases = [
        ((1024, 1024), torch.float32, LAPLACE),
        ((4096, 4096), torch.float32, LAPLACE),
        ((1021, 1000), torch.float32, LAPLACE),
        ((256, 256), torch.float64, LAPLACE),
        ((512, 512), torch.float32, CONV),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for grid, dtype, coeffs in cases:
        n = grid[0] * grid[1]
        x = torch.randn(n, dtype=dtype, device="cuda", generator=gen)
        y_kernel = stencil.stencil5_matvec_sliding(x, coeffs=coeffs, grid=grid)
        y_plain = stencil.stencil5_plain(x, coeffs, grid)
        torch.cuda.synchronize()
        err = (y_kernel - y_plain).abs().max().item()
        bound = (8 * torch.finfo(dtype).eps * sum(abs(c) for c in coeffs)
                 * x.abs().max().item())
        def kernel():
            return stencil.stencil5_matvec_sliding(x, coeffs=coeffs, grid=grid)

        def plain():
            return stencil.stencil5_plain(x, coeffs, grid)

        ms, plain_ms = graph_ms(kernel), graph_ms(plain)
        nbytes = 2 * n * x.element_size()
        res = {"grid": list(grid), "dtype": str(dtype).split(".")[-1],
               "coeffs": "laplace" if coeffs is LAPLACE else "convdiff",
               "max_abs_err": err, "bound": bound, "ms": ms,
               "plain_ms": plain_ms, "gbs": nbytes / ms / 1e6,
               "plain_gbs": nbytes / plain_ms / 1e6,
               "call_ms": median_ms(kernel), "plain_call_ms": median_ms(plain)}
        results.append(res)
        check("kernel", err <= bound, **res)
    return results


def phase_small(torch):
    """The same float64 stencil solve on the card (kernel) and on the CPU
    (plain version): the restart decisions must not change."""
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.problems import laplacian_2d

    v1 = np.random.default_rng(1).standard_normal(32 * 32)
    out = {}
    for dev in ("cuda", "cpu"):
        op = laplacian_2d(32, 32, fmt="stencil", dtype=torch.float64, device=dev)
        out[dev] = partial_schur(op, v1=v1, nev=6, which="SR", tol=1e-10)
    (dg, hg), (dc, hc) = out["cuda"], out["cpu"]
    lam_err = float(np.abs(dg.eigenvalues - dc.eigenvalues).max())
    check("small", hg.converged and hg.mvproducts == hc.mvproducts
          and lam_err <= 1e-9,
          mvproducts_cuda=hg.mvproducts, mvproducts_cpu=hc.mvproducts,
          lam_err=lam_err)


def phase_readme(torch):
    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.problems import laplacian_1d

    op = laplacian_1d(100, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    d, h = partial_schur(op, nev=10, which="SR", tol=1e-6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    op64 = laplacian_1d(100, dtype=torch.float64, device="cuda")
    Q = d.Q.double()
    R = torch.as_tensor(d.R, device="cuda")
    resid = torch.linalg.norm(op64.matmat(Q) - Q @ R).item()
    check("readme", h.converged and resid <= 5e-6,
          mvproducts=h.mvproducts, reference_mvproducts=174,
          restarts=h.restarts, schur_residual=resid, wall_s=wall,
          dense_layer=h.dense_layer)


def _stencil_resid(Q, R, coeffs, grid):
    """||A Q - Q R||_F with the plain stencil, in float64."""
    import torch

    from arnoldimethod_torch.ops.stencil import stencil5_plain

    Q = Q.double()
    AQ = torch.stack([stencil5_plain(Q[:, j], coeffs, grid)
                      for j in range(Q.shape[1])], dim=1)
    return torch.linalg.norm(AQ - Q @ torch.as_tensor(R, device=Q.device)).item()


def phase_main(torch):
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.operators import Stencil5Operator
    from arnoldimethod_torch.ops import stencil

    grid = (1024, 1024)
    op = Stencil5Operator(LAPLACE, grid, dtype=torch.float32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    stencil.KERNEL.launches = 0
    t0 = time.perf_counter()
    d, h = partial_schur(op, nev=20, which="SR", tol=1e-6, mindim=40,
                         maxdim=80, restarts=400, method="host")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = stencil.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()

    lam_exact = 0.130 * (4 - 4 * math.cos(math.pi / 1025))
    lam_min = float(np.min(d.eigenvalues.real))
    resid = _stencil_resid(d.Q, d.R, LAPLACE, grid)
    info = dict(
        n=grid[0] * grid[1], mvproducts=h.mvproducts, restarts=h.restarts,
        nconverged=h.nconverged, wall_s=wall, device_s=h.timings["device"],
        dense_s=h.timings["dense"], dense_layer=h.dense_layer,
        host_syncs=h.host_syncs, syncs_per_step=h.host_syncs / h.mvproducts,
        kernel_launches=launches, lam_min=lam_min, lam_exact=lam_exact,
        lam_min_err=abs(lam_min - lam_exact), schur_residual=resid,
        peak_mem_bytes=peak,
    )
    check("main", h.converged and h.nconverged == 20
          and abs(lam_min - lam_exact) <= 1e-5 and resid <= 1e-5
          and launches >= h.mvproducts, **info)
    return d, launches


def phase_eigen(torch, d):
    from arnoldimethod_torch import partial_eigen
    from arnoldimethod_torch.ops.stencil import stencil5_plain

    vals, X = partial_eigen(d)
    X = X.double()
    worst = 0.0
    ok = X.shape == (1024 * 1024, 20) and bool(torch.isfinite(X).all())
    # 1e-4 |lam| relative, floored at the solver's own criterion floor
    # eps(f32) * ||A|| (sum|coeff| bounds ||A||): for lam ~ 2.4e-6 the
    # relative bound alone sits below float32 rounding of A x.
    floor = 16 * torch.finfo(torch.float32).eps * sum(abs(c) for c in LAPLACE)
    for j, lam in enumerate(vals):
        x = X[:, j]
        r = torch.linalg.norm(stencil5_plain(x, LAPLACE, (1024, 1024))
                              - float(lam) * x).item()
        bound = max(1e-4 * abs(lam), floor)
        worst = max(worst, r / bound)
        ok = ok and r <= bound
    check("eigen", ok, k=len(vals), worst_residual_over_bound=worst,
          floor=floor)


def phase_profile(torch):
    """Device time by kernel over a short solve (3 restarts) of the main
    configuration, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.operators import Stencil5Operator

    op = Stencil5Operator(LAPLACE, (1024, 1024), dtype=torch.float32,
                          device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, h = partial_schur(op, nev=20, which="SR", tol=1e-6, mindim=40,
                             maxdim=80, restarts=3, method="host")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels, copies and memsets on the card.  The device-side spans of
    # the `arnoldi:*` annotations cover the kernels launched inside them,
    # and some torch versions do not flag them as annotations, so they are
    # left out by name as well.
    spans, by_name = [], {}
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA or ev.is_user_annotation
                or ev.name.startswith("arnoldi:")):
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        us, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (us + end - start, count + 1)
    # Busy time is the union of the spans (streams may overlap).
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_s = busy_us / 1e6
    rows = sorted(((us, name, c) for name, (us, c) in by_name.items()),
                  reverse=True)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_main.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    measured = bool(spans)
    emit({"phase": "profile", "ok": True, "restarts": h.restarts,
          "mvproducts": h.mvproducts, "wall_s": wall,
          "device_busy_s": busy_s if measured else "not measured",
          "device_busy_share": busy_s / wall if measured else "not measured",
          "device_idle_share": 1 - busy_s / wall if measured else "not measured",
          "device_launches": len(spans),
          "stencil5_device_ms": sum(us for name, (us, _) in by_name.items()
                                    if "stencil5" in name) / 1e3,
          "top": [{"kernel": k[:80], "device_ms": us / 1e3, "count": c}
                  for us, k, c in rows[:8]]})


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import arnoldimethod_torch  # noqa: F401  (fails outside the repository)

    card = phase_device(torch)
    phase_build()
    kernels = phase_kernel(torch)
    phase_small(torch)
    phase_readme(torch)
    d, launches = phase_main(torch)
    phase_eigen(torch, d)
    phase_profile(torch)

    main_shape = kernels[0]
    print(card, flush=True)
    emit({"kernels": [{
        "name": "stencil5",
        "route": "cuda",
        "source": "arnoldimethod_torch/csrc/stencil5.cu",
        "replaces": "arnoldimethod_tpu/ops/stencil_pallas.py:240",
        "also_replaces": "arnoldimethod_tpu/ops/stencil_pallas.py:157",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
