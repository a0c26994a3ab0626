#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card and check it.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --conv-starts   # config 3 from fourteen starts
    python3 chip_smoke.py --df-kernel     # the double-word kernels only
    python3 chip_smoke.py --project-sweep # df_project under other plans
    python3 chip_smoke.py --df-sweep      # df_basis_change's tiles and
                                          # stencil5_df's points a thread
    python3 chip_smoke.py --axpy-sweep    # df_axpy under other plans
    python3 chip_smoke.py --device        # the method="device" phases only
    python3 chip_smoke.py --dense-restart # the dense_restart_kernel phase only
    python3 chip_smoke.py --extended      # df_kernel and the extended solves
    python3 chip_smoke.py --sharded       # the four sharded phases only
    python3 chip_smoke.py --comm-costs    # the collectives' host cost only

Phases, each printed as one JSON line:

  device   the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc builds of the stencil, BSR, double-word and dense-restart
           kernels and the g++ build of the dense core, all started at
           once, from the sources (`_build.build_all`)
  kernel   the CUDA stencil kernel against its plain PyTorch version on the
           card, at five grids: max |difference| against
           8 * eps * sum|coeff| * max|x|; both device times per call (a
           CUDA graph of 20 calls, median of 10 replays) with the effective
           GB/s, both per-call times with host overhead (CUDA events
           around single calls, median of 30), and the library call
           F.conv2d (3x3 weight, padding=1, TF32 off) timed as the kernel
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
  lowsync_main  the main configuration with lowsync=True (CGS2, breakdown
           test on the card, no host read inside a Krylov step), from the
           same start: 20/20 within main's limits, host syncs at most
           restarts + 2 + rollbacks, matvecs, syncs a step, discarded
           speculative steps, the median wall of 3 runs beside the DGKS
           path's median of 3 in the same call, and a 3-restart profile
           (lowsync_profile, chiprun_out/profile_lowsync.txt) beside
           `profile`'s
  bsr_kernel   the CUDA BSR kernel against its plain PyTorch version (the
           gather + einsum, TF32 off) on the card, in ten cases: 512
           block-rows x 8 blocks of 128 (268 MB of f32 block data, and the
           same in f64), 37 x 11 blocks of 32 with duplicate columns, a
           1,000-row CsrOperator.to_bsr (n not a block multiple), blocks of
           8 in f64, the sparse_auto operator (64 x 8 x 128), a dense
           8192 x 8192 as 16 x 16 blocks of 512 (268 MB), 8 block-rows of
           64 slots of 128, blocks of 37 (the kernel's direct path), and
           264 x 40 x 128 in f64 (x staged window by window).  Bound per
           entry: 2 KB B eps (|A||x|); two
           calls must give bitwise-equal y; times as for `kernel`, with GB/s
           counting the logical block data and x and y; each case prints
           the kernel's launch plan and whether it is slower than plain
  bsr_small    a 512-row float64 BSR solve on the card (kernel) against the
           same solve on the CPU (plain): same matvec count, eigenvalues
  bsr_main     the 65,536-row BSR matrix (268 MB of block data, ten
           eigenvalues 1.0-1.9 outside a bulk of radius ~0.32), nev=10,
           :LM, tol=1e-6, float32: converged 10/10, Schur residual in
           float64, eigenvalues against a float64 plain solve on the card,
           kernel launches against the matvec count
  sparse_auto  an 8,192-row scipy.sparse matrix of the same construction
           through partial_schur(S, device="cuda"): the format rule picks
           BSR and the kernel runs; eigenvalues against the CSR layout
  bsr_profile  torch.profiler over the first restarts of the bsr_main solve
  cheb_kernel  the fused Chebyshev step kernel (stencil + three-term
           recurrence) against its plain PyTorch version at 3200^2, 1024^2,
           1021 x 1000 f32 and 256^2 f64, each with q = 0 (no z), q != 0
           and y written over z; bound 8 eps (|p| |inv_e| (sum|coeff| + |c|)
           max|x| + |q| max|z|); device ms per step (graph) and GB/s
           counting 12 (24) bytes a point; then one degree-1000 filtered
           matvec at 3200^2 through the kernel and through plain torch
  e2e10m   the north star: nev=100 smallest eigenvalues of the 3200^2
           (10,240,000-row) Laplacian stencil, float32, by the Chebyshev
           recipe (estimate_interval, a degree-1000 filter, partial_schur
           :LM with maxdim=200, rayleigh_ritz): 100/100 converged,
           eigenvalue error against the analytic spectrum, residuals,
           fused-kernel launches = filtered matvecs x 1000, peak memory
  shiftinv the reference's config 4: n = 6,000 tridiagonal shift-invert at
           sigma = 0 (float32 with refinement), nev=10, :LM; and float64
           from one v1 on the card and on the CPU: same matvec count
  conv1m   the 1,048,576-row periodic convection-diffusion circulant
           through the FFT shift-invert with a staged sigma walk, nev=12,
           :LM, complex Ritz pairs checked against the exact DFT symbol
  default_device  partial_schur(laplacian_1d(100), nev=10, which="SR")
           with no device named: operator and basis on the card
  complex_bsr  a complex clustered scipy matrix (4,096 rows of 128-blocks)
           through partial_schur(S, device="cuda"): BSR picked, four BSR
           launches a matvec (two words), eigenvalues against the same
           solve in complex128 on the CPU
  complexsc  bench.py's complex_sc in the port: n = 1500 complex64 dense,
           split_complex=True (four real GEMVs a matvec), nev=8, :LI,
           tol=1e-5, mindim=16, maxdim=32: converged, ||AQ - QR|| / ||A||
           and ||Q^H Q - I|| at most 1e-5 and the :LI eigenvalues within
           1e-4 of LAPACK's, all in complex128 on the host; the median
           wall of 3 warm runs
  complexscsparse  bench.py's complex_sc_sparse in the port: a 1,048,576-row
           complex tridiagonal with 10 planted eigenvalues, as a
           SplitComplexOperator over two float32 DiaOperators,
           split_complex=True, the same keywords: converged, the 8 largest
           imaginary parts within 0.021 of the planted ones, the float64
           host residual and orthonormality; the native complex64
           DiaOperator of the same matrix beside it (matvecs, walls)
  df_kernel  two_prod's exactness for both words, then the double-word
           kernels (df_project, its one-row norm form, df_axpy and its
           fused norm, df_normalize's step form, df_basis_change,
           stencil5_df) against
           their plain versions, bitwise, in float32 and float64 words at
           config 3's shapes (61 x 65,536; 256^2), 61 x 1,048,576 and 1021
           x 1000; ms (CUDA graph of 20 calls), GB/s and the bound,
           df_project's beside the two-pass kernel's it replaced,
           df_basis_change's and stencil5_df's beside their run-F times,
           df_axpy's and its fused form's beside the earlier column
           kernel's (COLUMN_AXPY_MS), with their targets, and
           df_normalize's beside df_mul_by's record; df_axpy in both
           forms at rows 31 and 46, and its fused form under CUDA-graph
           replays on a warm and a fresh stream; df_normalize at 65,536 and
           1,048,576 rows, both words, aligned and one word off, in every
           decision of its step form and its one-sum form; then
           df_project alone: the full form at rows 1, 7 and 60, the one-row
           form at n = 1, 1,000, 65,536 and 1,048,576 (bitwise with acc,
           both words), 20 calls in a CUDA graph replayed 10 times against
           one eager call; df_basis_change at rows 31, 46, 61 (new tensors
           and in place) and stencil5_df at 64^2; df_rank_sum (the sharded
           extended path's sum over the ranks) at 1, 2, 3, 4 and 8 ranks
           (k = 62) and k = 1, with and without acc; the gathered forms
           (df_axpy_gathered, df_normalize's step form with a gathered s2)
           at 1, 2, 3 and 8 ranks in both words, bitwise against
           df_rank_sum followed by the form they replace and against
           their plain versions, each timed beside that pair, and the
           fold's prologue cost at 1, 2, 8, 64 and 256 ranks
           (gathered_prologue); and ptxas' registers,
           stack and spills of each of the 115 instantiations (no local
           memory).  The
           operations bound counts lane-instructions (each operand split
           once) over SMs x 128 (float32) or 64 (float64) a clock at the
           card's maximum SM clock
  ext_readme  extended=True, laplacian_1d(100), float32 words, tol=1e-12
           from one v1: residual below 1e-11, same count on card and CPU
  ext_dd   float64 words (double-double dense layer), tol=1e-28: at most
           600 matvecs, exact-rational residual below 1e-26 and
           orthonormality below 1e-28; laplacian_1d(40) at 1e-24 gives the
           same count on card and CPU
  ext_conv config 3 at full size (n = 65,536 convection-diffusion,
           nev=10, :LM, extended=True, from a numpy-seeded v1): converged,
           complex pairs, residual in host float64 at most 1e-8, every
           double-word kernel launched, no plain double-word op on the
           card, and the two-pass kernel's result repeated exactly (6,387
           matvecs, 213 restarts, residual 3.872e-12); df_mul_by gone and
           df_normalize launched; host reads a step at most (ranges +
           rollbacks + 3) / matvecs; df_project's launches split into its
           one-row and full forms (one-row fewer than 7,000: every pass's
           norm comes from its df_axpy), df_axpy's into plain and fused;
           then the same solve with df_expand_range_stepwise swapped in
           (its host decisions, one or two reads a step) and the range's
           solve once more: the same bits, the walls and their ratio; the
           host's microseconds a call of each wrapper of a step
           (ext_conv_host); a profile of its first restarts gives the
           device's busy share, device launches a Krylov step (at most 8)
           and the share of the device time of df_project, df_axpy,
           df_normalize, df_basis_change and stencil5_df
           (chiprun_out/profile_conv.txt), and shows one device launch a
           df_project call (ext_conv_one_launch; profiled once more when
           the profiler lost device records)
  roofline bench.py's memcpy in the port: a 1 GiB device-to-device copy,
           its rate beside the published 3.35 TB/s; the kernel summary
           restates each bytes bound at it
  dense_restart_kernel  method="device"'s restart and finish kernels
           (csrc/dense_restart.cu) against their plain versions, run on the
           host CPU: Arnoldi H at m = 20, 80 and 200 in float32 and float64,
           a purge restart and the H of device_main's third restart; the
           integer outputs equal, H, Q, Qbig and the finish outputs within
           1e-4 (float32) or 1e-10 (float64) of max|H| and bitwise (signed
           zeros too), and so are a launch with the phase stamps and one
           with the helper warp turned the other way; ms a call (a graph
           of 20 calls, the input restored before each, no stamps) beside
           PR 11's kernel's (earlier_ms, a record, not measured here), the
           plain version's and the host C++ core's on the same H; the
           helper on and off and the stamps on, each twice in graphs of 5
           calls in the order A B C C B A (variants_ms; helper_gain, the
           time without the helper over the time with it; stamps_cost,
           with the stamps over without); the operations
           bound (lane operations of the plain version's rotations and
           reflectors, dense.device.PLAIN_OPS) over the card's rate and over
           one SM's; where the launch kept H and Q (storage), its Francis
           sweeps and rotation steps, and the ms of each phase from the
           kernel's clock64() stamps (phases_ms: each phase's share of the
           stamped clocks times ms; phases_ms_at_max_clock: its clocks at
           clocks.max.sm)
  dense_restart_helper  the restart kernel with the helper warp on and off
           on Arnoldi H at m = 20 to 80 in float32 and float64: the same
           bits, ms a call of each and their ratio (helper_gain) beside the
           wrapper's choice (dense.device.uses_helper)
  device_readme  the README configuration with method="device" on the card
           and on the CPU from one v1: the same matvec and restart counts
  device_main  config 2 with method="device" (bench.py's e2e_1m_device) and
           with method="host" from one v1 in the same call: 20/20 within
           main's limits, reads at most restarts + rollbacks + 1, stencil
           launches = matvecs + discarded steps, restart-kernel launches,
           median walls of 3 each and their ratio, and 3-restart profiles
           of both
           (chiprun_out/profile_device.txt, profile_device_host.txt)
  sharded_p1  the row-sharded solver (arnoldimethod_torch/parallel/) on a
           one-rank NCCL group, config 2 three ways from one v1, each beside
           its unsharded solve: the scipy CSR matrix through shard_operator
           (a ShardedCsrOperator) with the host DGKS method, the same with
           lowsync=True, and method="device" with the stencil behind the
           gathering wrapper (K1 and the restart kernel launch); Q, R and the
           counts bitwise the unsharded solve's, 20/20 within main's limits;
           collectives, bytes and host reads a step, both walls; the host
           and device microseconds of each collective (comm_us; also in a
           fresh process with and without NCCL's flight recorder), and
           3-restart profiles of the sharded DGKS and device ways
           (chiprun_out/profile_sharded_*.txt)
  sharded_p2  two processes sharing cuda:0 through gloo (NCCL refuses two
           ranks on one device), each `chip_smoke.py --sharded-rank`: a
           probe of every collective the comm layer makes on CUDA tensors,
           then config 2's CSR matrix split over the two ranks with DGKS in
           both gather modes to convergence (20/20 within main's limits),
           lowsync=True and method="device" (the stencil behind the
           wrapper) for P2_SHORT restarts; both ranks must report the same
           counts; then a DIA band wider than a rank's rows (+-150 at
           n = 256, float64): the unsharded solve's counts and eigenvalues
           on both ranks; walls labelled as two ranks on one card, not a
           multi-GPU figure
           (chiprun_out/sharded_p2/rank*.log, rank*.json)
  sharded_ext_p1  extended=True with sharding= on a one-rank NCCL group,
           each beside its unsharded solve: config 3 at full size (as
           ext_conv) through the gathering wrapper (stencil5_df on the
           full grid) and the README matrix in float64 words at tol=1e-28
           (as ext_dd) through the sharded DIA operator; Q, Q_lo, R, R_lo,
           matvecs, restarts and host reads bitwise the unsharded solve's,
           config 3's 6,387 / 213 repeated; three gathers a Krylov step,
           folded by its two gathered df_axpy and one gathered
           df_normalize launches, df_rank_sum only outside a step (all
           exact), every other df.cu launch the unsharded solve's (7 a
           step); collectives, bytes and df.cu launches a step, both walls;
           the host microseconds of df_sum and its parts and of the
           wrapper's matvec_df (comm_us); one Krylov step in its gathered
           form and in its df_rank_sum form (a launch a sum): the same
           bits and each one's host microseconds (step_us); a 3-restart
           profile (chiprun_out/profile_sharded_ext.txt)
  sharded_ext_p2  two processes sharing cuda:0 through gloo, each
           `chip_smoke.py --sharded-ext-rank`: laplacian_1d(100) in float32
           words at tol=1e-12 to convergence, residual below 1e-11 and the
           same counts on the card as on the CPU at two ranks; config 3
           for P2_SHORT restarts; both ranks' counts, R and config 3's H
           equal; one Krylov step of config 3 in its gathered form and in
           its df_rank_sum form, the same bits on both ranks; the wide DIA
           band in float32 words with the unsharded solve's counts
           (chiprun_out/sharded_ext_p2/)

Then the card's nvidia-smi line, the kernel summary line (each kernel's
launches on its main path, by phase for the stencil and the restart
kernels, error against its plain version, ms, plain ms, bound and
library-call ms) and, last, the result line.  Any failed check
ends the run with a non-zero exit code and no result line; so does a
machine without CUDA.
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
    Host launch overhead is out of the picture.  The graph is captured on
    the stream that warmed it up, so that df_project's scratch, kept per
    stream, is allocated outside the graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    clock_mhz = float(clock.stdout.split()[0]) if clock.returncode == 0 else 0.0
    sms = set_peak_ops(torch, clock_mhz)
    CLOCK_MHZ["sm"] = clock_mhz
    check("device", smi.returncode == 0 and card and clock_mhz > 0,
          nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
          name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          python=sys.version.split()[0], sm_count=sms,
          sm_clock_max_mhz=clock_mhz, peak_ops_s=PEAK_OPS_S)
    return card


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _ptxas(log):
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]


def phase_build():
    """The four nvcc builds and the g++ build run at once, one thread
    each (`_build.build_all`)."""
    from arnoldimethod_torch._build import BUILD_DIR, build_all
    from arnoldimethod_torch.dense import device, native
    from arnoldimethod_torch.ops import bsr, df, stencil

    # Libraries already built by an earlier run are loaded, not rebuilt;
    # then the times below are load times.
    prebuilt = sorted(p.name for p in BUILD_DIR.glob("*.so"))
    seconds = build_all()
    check("build", True, seconds=seconds, prebuilt=prebuilt,
          native=native.available(), native_error=native.build_error,
          ptxas=_ptxas(stencil.KERNEL.build_log),
          bsr_ptxas=_ptxas(bsr.KERNEL.build_log),
          df_ptxas=_ptxas(df.KERNEL.build_log),
          dense_restart_ptxas=_dense_ptxas(device.KERNEL.build_log))


def _conv2d_stencil(torch, x, coeffs, grid):
    """The library call for the stencil: F.conv2d with the 3x3 weight of
    the five coefficients, padding=1 (the zero boundary), TF32 off.  Returns
    the call and its max |difference| from the plain stencil."""
    import torch.nn.functional as F

    from arnoldimethod_torch.ops import stencil
    from arnoldimethod_torch.ops.expansion import fp32_matmul

    c, w, e, no, so = coeffs
    weight = torch.tensor([[0.0, no, 0.0], [w, c, e], [0.0, so, 0.0]],
                          dtype=x.dtype, device=x.device)[None, None]
    x4 = x.reshape(1, 1, *grid)

    def library():
        with fp32_matmul():
            return F.conv2d(x4, weight, padding=1)

    err = (library().reshape(-1) - stencil.stencil5_plain(x, coeffs, grid)
           ).abs().max().item()
    return library, err


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

        library, library_err = _conv2d_stencil(torch, x, coeffs, grid)
        ms, plain_ms = graph_ms(kernel), graph_ms(plain)
        library_ms = graph_ms(library)
        nbytes = 2 * n * x.element_size()
        word = str(dtype).split(".")[-1]
        # One multiply and four FMAs a point.
        bound_ms, bound_by = roofline(nbytes, 5 * n, word)
        res = {"grid": list(grid), "dtype": word,
               "coeffs": "laplace" if coeffs is LAPLACE else "convdiff",
               "max_abs_err": err, "bound": bound, "ms": ms,
               "plain_ms": plain_ms, "gbs": nbytes / ms / 1e6,
               "plain_gbs": nbytes / plain_ms / 1e6,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "library_max_abs_err": library_err,
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
    from arnoldimethod_torch.ops import bsr, stencil

    grid = (1024, 1024)
    op = Stencil5Operator(LAPLACE, grid, dtype=torch.float32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    stencil.KERNEL.launches = bsr.KERNEL.launches = 0
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
    return d, launches, wall


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


def _profile(torch, phase, op, kernel, out_name, label=None, parts=None,
             **kw):
    """Device time by kernel over a short solve of `op` (partial_schur with
    `kw`) and the device's busy share of the wall time; the profiler's
    table goes to chiprun_out/<out_name>.  `kernel` is matched in the
    kernels' names; `label` (default `kernel`) names its time.  `parts`
    maps more labels to name fragments, each reported with its share of
    the device time and its count of launches.  Returns the printed line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arnoldimethod_torch import partial_schur

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The profiler can miss a session's first device records (a fill
        # and a one-row df_project of ext_conv's solve, PR 14 run E): a
        # marker kernel goes first, and its records are left out below.
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, h = partial_schur(op, **{"method": "host", **kw})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels, copies and memsets on the card.  The device-side spans of
    # the `arnoldi:*` annotations cover the kernels launched inside them,
    # and some torch versions do not flag them as annotations, so they are
    # left out by name as well.
    spans, by_name = [], {}
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA or ev.is_user_annotation
                or ev.name.startswith("arnoldi:")
                or "spin_kernel" in ev.name):
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
    with open(os.path.join(out_dir, out_name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    measured = bool(spans)

    def device_ms(fragment):
        return sum(us for name, (us, _) in by_name.items()
                   if fragment in name) / 1e3

    line = {"phase": phase, "ok": True, "restarts": h.restarts,
            "mvproducts": h.mvproducts, "wall_s": wall,
            "device_busy_s": busy_s if measured else "not measured",
            "device_busy_share": busy_s / wall if measured else "not measured",
            "device_idle_share": 1 - busy_s / wall if measured else "not measured",
            "device_launches": len(spans),
            # Each host read of a device value is one device-to-host copy.
            "dtoh_copies": sum(c for k, (_, c) in by_name.items()
                               if "DtoH" in k),
            f"{label or kernel}_device_ms": device_ms(kernel)}
    for name, fragment in (parts or {}).items():
        ms = device_ms(fragment)
        line[f"{name}_device_ms"] = ms
        line[f"{name}_share_of_device"] = (ms / busy_us * 1e3 if measured
                                           else "not measured")
        line[f"{name}_device_launches"] = sum(
            c for k, (_, c) in by_name.items() if fragment in k)
    line["top"] = [{"kernel": k[:80], "device_ms": us / 1e3, "count": c}
                   for us, k, c in rows[:8]]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    line["host_top"] = [{"op": e.key[:60], "self_cpu_ms": e.self_cpu_time_total
                         / 1e3, "count": e.count} for e in host[:10]]
    emit(line)
    return line


def phase_profile(torch):
    """Device time by kernel over a short solve (3 restarts) of the main
    configuration, and the device's busy share of the wall time."""
    from arnoldimethod_torch.models.operators import Stencil5Operator

    op = Stencil5Operator(LAPLACE, (1024, 1024), dtype=torch.float32,
                          device="cuda")
    return _profile(torch, "profile", op, "stencil5", "profile_main.txt",
                    parts=MAIN_PARTS, **MAIN_KW, restarts=3)


# The main configuration's keywords, and the device-time parts its
# profiles report.
MAIN_KW = dict(nev=20, which="SR", tol=1e-6, mindim=40, maxdim=80)
MAIN_PARTS = {"gemv": "gemv", "stencil": "stencil5"}


def phase_lowsync_main(torch, dgks_wall, dgks_profile):
    """The main configuration with lowsync=True from the same start (the
    solver's seeded random start), driven once with the counts at 0;
    then two more runs of each expansion in turns for median walls, and a
    3-restart profile beside the DGKS one.  Returns the stencil kernel's
    launches in the driven run."""
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.operators import Stencil5Operator
    from arnoldimethod_torch.ops import stencil
    from arnoldimethod_torch.ops.expansion import LOWSYNC

    grid = (1024, 1024)
    op = Stencil5Operator(LAPLACE, grid, dtype=torch.float32, device="cuda")
    kw = dict(MAIN_KW, restarts=400, method="host")

    def solve(lowsync):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, h = partial_schur(op, lowsync=lowsync, **kw)
        torch.cuda.synchronize()
        return d, h, time.perf_counter() - t0

    stencil.KERNEL.launches = 0
    LOWSYNC.rollbacks = LOWSYNC.discarded_matvecs = 0
    d, h, wall = solve(True)
    launches = stencil.KERNEL.launches
    rollbacks, discarded = LOWSYNC.rollbacks, LOWSYNC.discarded_matvecs
    walls, dgks_walls, dgks = [wall], [dgks_wall], None
    for _ in range(2):
        _, dgks, w = solve(False)
        dgks_walls.append(w)
        walls.append(solve(True)[2])

    lam_exact = 0.130 * (4 - 4 * math.cos(math.pi / 1025))
    lam_min = float(np.min(d.eigenvalues.real))
    resid = _stencil_resid(d.Q, d.R, LAPLACE, grid)
    prof = _profile(torch, "lowsync_profile", op, "stencil5",
                    "profile_lowsync.txt", parts=MAIN_PARTS, **MAIN_KW,
                    restarts=3, lowsync=True)
    keys = ("device_busy_share", "device_busy_s", "gemv_device_ms",
            "stencil_device_ms", "device_launches", "dtoh_copies", "wall_s",
            "mvproducts")
    sync_limit = h.restarts + 2 + rollbacks
    check("lowsync_main", h.converged and h.nconverged == 20
          and abs(lam_min - lam_exact) <= 1e-5 and resid <= 1e-5
          and h.host_syncs <= sync_limit and launches >= h.mvproducts,
          n=grid[0] * grid[1], mvproducts=h.mvproducts, restarts=h.restarts,
          nconverged=h.nconverged, host_syncs=h.host_syncs,
          host_sync_limit=sync_limit,
          syncs_per_step=h.host_syncs / h.mvproducts, rollbacks=rollbacks,
          discarded_matvecs=discarded, wall_s_median=statistics.median(walls),
          walls_s=walls, device_s=h.timings["device"],
          dense_s=h.timings["dense"], lam_min=lam_min, lam_exact=lam_exact,
          lam_min_err=abs(lam_min - lam_exact), schur_residual=resid,
          kernel_launches=launches,
          profile={k: prof[k] for k in keys},
          dgks={"mvproducts": dgks.mvproducts, "restarts": dgks.restarts,
                "host_syncs": dgks.host_syncs,
                "syncs_per_step": dgks.host_syncs / dgks.mvproducts,
                "wall_s_median": statistics.median(dgks_walls),
                "walls_s": dgks_walls,
                "profile": {k: dgks_profile[k] for k in keys}})
    return launches


def bsr_pattern(nbr, KB, B, dtype, seed=7, nbc=None):
    """Block columns and blocks of the clustered BSR test matrix: block-row
    r holds its diagonal block and KB - 1 other distinct blocks (sorted)
    among nbc block columns (nbr by default), entries N(0, 0.01^2), plus
    1.0 + 0.1 i on diagonal entries i < 10.  Ten eigenvalues near 1.0-1.9
    then lie well outside the disk of radius about 0.01 sqrt(KB B) that
    holds the rest."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nbc = nbr if nbc is None else nbc
    cols = np.empty((nbr, KB), dtype=np.int32)
    for r in range(nbr):
        others = rng.choice(nbc - 1, size=KB - 1, replace=False)
        cols[r] = np.sort(np.append(others + (others >= r), r))
    data = rng.standard_normal((nbr, KB, B, B), dtype=dtype)
    data *= dtype(0.01)
    for g in range(10):  # diagonal entry g lies in diagonal block g // B
        r = g // B
        k = int(np.searchsorted(cols[r], r))
        data[r, k, g % B, g % B] += 1.0 + 0.1 * g
    return cols, data


def _clustered_csr(n):
    """A band of width 7 plus one dense corner block, as CSR arrays."""
    import numpy as np

    rng = np.random.default_rng(9)
    i = np.repeat(np.arange(n), 7)
    j = i + np.tile(np.arange(-3, 4), n)
    keep = (j >= 0) & (j < n)
    k = n // 4
    ci, cj = np.divmod(np.arange(k * k), k)
    rows = np.concatenate([i[keep], ci])
    cols = np.concatenate([j[keep], cj + n - k])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return indptr, cols, rng.standard_normal(rows.size)


def bsr_cases(torch, op32, op64):
    """The BSR kernel's cases: (name, cols, dataT, logical (nbr, KB), nbc),
    packed operands on the card, each with the reason it is here."""
    import numpy as np

    from arnoldimethod_torch.models.operators import CsrOperator, dense_to_bsr
    from arnoldimethod_torch.ops import bsr

    def packed(cols, data, nbc=None):
        c, d = bsr.pack_bsr(cols, data)
        return (torch.from_numpy(c).cuda(), torch.from_numpy(d).cuda(),
                cols.shape, nbc or d.shape[0])

    def operator(op):
        return (op.block_cols, op.block_dataT, op.logical_blocks,
                -(-op.shape[0] // op.block_size))

    def on_card(nbr, KB, B, dtype, seed):
        """Distinct sorted block columns and N(0, 0.01^2) blocks made on the
        card, already packed (nbr and KB multiples of 8)."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        cols = torch.rand(nbr, nbr, device="cuda", generator=gen).argsort(
            dim=1)[:, :KB].sort(dim=1).values.to(torch.int32).contiguous()
        data = torch.randn(nbr, KB, B, B, dtype=dtype, device="cuda",
                           generator=gen).mul_(0.01)
        return cols, data, (nbr, KB), nbr

    # 37 x 11 blocks of 32: KB and nbr are no multiples of 8, and three
    # slots of every block-row repeat one of its first eight columns.
    rng = np.random.default_rng(3)
    dup_cols = np.stack([np.sort(rng.choice(37, 8, replace=False))
                         for _ in range(37)])
    dup_cols = np.concatenate(
        [dup_cols, np.take_along_axis(dup_cols, rng.integers(0, 8, (37, 3)),
                                      axis=1)], axis=1).astype(np.int32)
    dup_data = rng.standard_normal((37, 11, 32, 32)).astype(np.float32)
    indptr, idx, vals = _clustered_csr(1000)
    to_bsr = CsrOperator(indptr, idx, vals.astype(np.float32), (1000, 1000),
                         device="cuda").to_bsr(128)
    dense = dense_to_bsr(np.random.default_rng(5).standard_normal(
        (8192, 8192), dtype=np.float32), 512, device="cuda")
    return [
        # The bsr_main operator, 268 MB past the 50 MB L2; and in f64.
        ("512x8x128_f32", *operator(op32)),
        ("512x8x128_f64", *operator(op64)),
        # Padding in both extents, duplicate columns.
        ("37x11x32_f32_dup", *packed(dup_cols, dup_data)),
        # A scipy-style matrix re-blocked: 8 block-rows, n no block multiple.
        ("to_bsr_n1000_f32", *operator(to_bsr)),
        # Small blocks: B below a warp.
        ("1024x8x8_f64", *packed(*bsr_pattern(1024, 8, 8, np.float64))),
        # The sparse_auto operator (33.5 MB).
        ("64x8x128_f32", *packed(*bsr_pattern(64, 8, 128, np.float32))),
        # Few block-rows of large blocks: a dense 8192 x 8192, 268 MB.
        ("16x16x512_f32", *operator(dense)),
        # Few block-rows with long slot lists, 33.5 MB.
        ("8x64x128_f32", *packed(*bsr_pattern(8, 64, 128, np.float32, nbc=64),
                                 nbc=64)),
        # Odd B: blocks no multiple of 16 bytes take the direct path.
        ("64x8x37_f32_direct", *packed(*bsr_pattern(64, 8, 37, np.float32))),
        # One CTA's x segments (40 x 128 f64) pass the shared-memory window
        # and are staged window by window (1.4 GB).
        ("264x40x128_f64_xwindow", *on_card(264, 40, 128, torch.float64, 11)),
    ], (dup_cols, dup_data)


def _bsr_library_ms(torch, cols, dataT, logical, x, y_plain):
    """The library call for the BSR matvec: torch.sparse_bsr_tensor of the
    logical blocks times x as a column (TF32 off).  Returns (ms, note):
    ms from a CUDA graph of 20 calls, else from CUDA events around single
    calls when the call cannot be captured, else None with the reason."""
    from arnoldimethod_torch.ops.expansion import fp32_matmul

    nbr, KB = logical
    B = dataT.shape[-1]
    try:
        values = dataT[:nbr, :KB].transpose(2, 3).reshape(nbr * KB, B, B)
        crow = torch.arange(0, nbr * KB + 1, KB, dtype=torch.int32,
                            device=x.device)
        A = torch.sparse_bsr_tensor(crow, cols[:nbr, :KB].reshape(-1),
                                    values.contiguous(),
                                    size=(nbr * B, x.numel()))
        xc = x[:, None]

        def library():
            with fp32_matmul():
                return A @ xc

        err = (library()[:, 0] - y_plain[:nbr * B]).abs().max().item()
    except Exception as exc:  # the library has no such product here
        return None, f"cannot run: {type(exc).__name__}: {exc}"[:300]
    try:
        return graph_ms(library), f"CUDA graph; max |y - plain| {err:.3e}"
    except Exception as exc:
        torch.cuda.synchronize()
        return median_ms(library), (f"CUDA events (graph capture failed: "
                                    f"{type(exc).__name__}); max |y - plain| "
                                    f"{err:.3e}")


def phase_bsr_kernel(torch, op32, op64):
    """The BSR kernel against bsr_plain on the card (TF32 off for both)."""
    import numpy as np

    from arnoldimethod_torch.ops import bsr
    from arnoldimethod_torch.ops.expansion import fp32_matmul

    cases, (dup_cols, dup_data) = bsr_cases(torch, op32, op64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    with fp32_matmul():
        for name, cols, dataT, logical, nbc in cases:
            nbr, KB, B, _ = dataT.shape
            x = torch.randn(nbc * B, dtype=dataT.dtype, device="cuda",
                            generator=gen)
            y_kernel = bsr.bsr_matvec(cols, dataT, x, logical)
            y_again = bsr.bsr_matvec(cols, dataT, x, logical)
            y_plain = bsr.bsr_plain(cols, dataT, x)
            ax = bsr.bsr_plain(cols, dataT.abs(), x.abs())
            bound = 2 * KB * B * torch.finfo(dataT.dtype).eps * ax
            diff = (y_kernel - y_plain).abs()
            bitwise = torch.equal(y_kernel, y_again)
            ok = bool((diff <= bound).all()) and bitwise
            if name.endswith("_dup"):
                # The kernel takes the unpacked operands as they are.
                c0 = torch.from_numpy(dup_cols).cuda()
                d0 = torch.from_numpy(
                    np.ascontiguousarray(dup_data.transpose(0, 1, 3, 2))).cuda()
                y0 = bsr.KERNEL(c0, d0, x)
                ok = ok and bool(((y0 - y_plain[:37 * 32]).abs()
                                  <= bound[:37 * 32]).all())

            def kernel():
                return bsr.bsr_matvec(cols, dataT, x, logical)

            def plain():
                return bsr.bsr_plain(cols, dataT, x)

            ms, plain_ms = graph_ms(kernel), graph_ms(plain)
            plan = bsr.KERNEL.plan(dataT, logical)
            block_bytes = logical[0] * logical[1] * B * B * dataT.element_size()
            nbytes = block_bytes + (x.numel() + nbr * B) * dataT.element_size()
            word = str(dataT.dtype).split(".")[-1]
            # One FMA a stored block entry.
            bound_ms, bound_by = roofline(
                nbytes, logical[0] * logical[1] * B * B, word)
            library_ms, library_note = (
                _bsr_library_ms(torch, cols, dataT, logical, x, y_plain)
                if name == "512x8x128_f32" else (None, "timed at the main case only"))
            res = {"case": name, "shape": [nbr, KB, B], "logical": list(logical),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "library_note": library_note,
                   "dtype": str(dataT.dtype).split(".")[-1],
                   "block_data_bytes": block_bytes,
                   "plan": {"S": plan.S, "threads": plan.threads,
                            "stages": plan.stages, "stage_bytes": plan.stage_bytes,
                            "path": plan.path, "grid": plan.grid,
                            "smem_bytes": plan.smem_bytes},
                   "max_abs_err": diff.max().item(),
                   "max_bound": bound.max().item(),
                   "worst_err_over_bound": (diff / bound.clamp_min(
                       torch.finfo(dataT.dtype).tiny)).max().item(),
                   "bitwise_repeat": bitwise,
                   "ms": ms, "plain_ms": plain_ms,
                   "slower_than_plain": ms > plain_ms,
                   "gbs": nbytes / ms / 1e6, "plain_gbs": nbytes / plain_ms / 1e6,
                   "call_ms": median_ms(kernel), "plain_call_ms": median_ms(plain)}
            results[name] = res
            check("bsr_kernel", ok, **res)
    return results["512x8x128_f32"]


def phase_bsr_small(torch):
    """The same float64 BSR solve on the card (kernel) and on the CPU
    (plain version): the restart decisions must not change."""
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.operators import BsrOperator
    from arnoldimethod_torch.ops import bsr

    cols, data = bsr_pattern(16, 8, 32, np.float64)
    v1 = np.random.default_rng(1).standard_normal(512)
    out = {}
    for dev in ("cuda", "cpu"):
        op = BsrOperator(cols, data, (512, 512), device=dev)
        bsr.KERNEL.launches = 0
        out[dev] = partial_schur(op, v1=v1, nev=6, which="LM", tol=1e-10)
        out[dev + "_launches"] = bsr.KERNEL.launches
    (dg, hg), (dc, hc) = out["cuda"], out["cpu"]
    lam_err = float(np.abs(dg.eigenvalues - dc.eigenvalues).max())
    check("bsr_small", hg.converged and hg.mvproducts == hc.mvproducts
          and lam_err <= 1e-9 and out["cuda_launches"] >= hg.mvproducts
          and out["cpu_launches"] == 0,
          mvproducts_cuda=hg.mvproducts, mvproducts_cpu=hc.mvproducts,
          kernel_launches_cuda=out["cuda_launches"], lam_err=lam_err)


def phase_bsr_main(torch, op32, op64):
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.ops import bsr, stencil

    n = op32.shape[0]
    v1 = np.random.default_rng(1).standard_normal(n)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    stencil.KERNEL.launches = bsr.KERNEL.launches = 0
    t0 = time.perf_counter()
    d, h = partial_schur(op32, v1=v1, nev=10, which="LM", tol=1e-6,
                         method="host")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsr.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()

    # The Schur residual in float64 with the plain version on the float64
    # copy of the same matrix, and a float64 plain solve from the same v1.
    Q = d.Q.double()
    resid = torch.linalg.norm(
        op64.matmat(Q) - Q @ torch.as_tensor(d.R, device="cuda")).item()
    t0 = time.perf_counter()
    d64, h64 = partial_schur(op64, v1=v1, nev=10, which="LM", tol=1e-10,
                             method="host")
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    lam = np.sort_complex(d.eigenvalues)
    lam64 = np.sort_complex(d64.eigenvalues)
    lam_err = (float(np.abs(lam - lam64).max()) if lam.shape == lam64.shape
               else math.inf)
    info = dict(
        n=n, block_data_bytes=op32.block_dataT.numel() * 4,
        mvproducts=h.mvproducts, restarts=h.restarts, nconverged=h.nconverged,
        wall_s=wall, device_s=h.timings["device"], dense_s=h.timings["dense"],
        dense_layer=h.dense_layer, host_syncs=h.host_syncs,
        syncs_per_step=h.host_syncs / h.mvproducts, kernel_launches=launches,
        stencil_launches=stencil.KERNEL.launches, schur_residual=resid,
        eigenvalues=[[z.real, z.imag] for z in lam], lam_err_vs_f64=lam_err,
        f64_mvproducts=h64.mvproducts, f64_converged=h64.converged,
        f64_wall_s=wall64, peak_mem_bytes=peak,
        resident_before_bytes=resident,
    )
    check("bsr_main", h.converged and h.nconverged == 10 and h64.converged
          and resid <= 2e-5 and lam_err <= 1e-5 and launches >= h.mvproducts,
          **info)
    return launches


def phase_sparse_auto(torch):
    """scipy.sparse input through partial_schur on the card: the format
    rule picks BSR and the kernel runs; the CSR layout agrees."""
    import numpy as np
    import scipy.sparse as sp

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.operators import (
        as_operator,
        pick_sparse_format,
    )
    from arnoldimethod_torch.ops import bsr, stencil

    nbr, KB, B = 64, 8, 128
    n = nbr * B
    cols, data = bsr_pattern(nbr, KB, B, np.float32)
    S = sp.bsr_matrix((data.reshape(-1, B, B), cols.ravel(),
                       np.arange(0, nbr * KB + 1, KB)), shape=(n, n)).tocsr()
    fmt, info = pick_sparse_format(S.indptr, S.indices, S.shape)
    # The host cost of the entry point alone: format rule, repack, upload.
    op, convert_s = _timed(lambda: as_operator(S, device="cuda"))
    torch.cuda.synchronize()
    v1 = np.random.default_rng(1).standard_normal(n)
    kw = dict(device="cuda", v1=v1, nev=6, which="LM", tol=1e-6)
    stencil.KERNEL.launches = bsr.KERNEL.launches = 0
    t0 = time.perf_counter()
    d, h = partial_schur(S, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsr.KERNEL.launches
    t0 = time.perf_counter()
    dc, hc = partial_schur(S, sparse_format="csr", **kw)
    torch.cuda.synchronize()
    wall_csr = time.perf_counter() - t0
    lam, lam_csr = np.sort_complex(d.eigenvalues), np.sort_complex(dc.eigenvalues)
    lam_err = (float(np.abs(lam - lam_csr).max()) if lam.shape == lam_csr.shape
               else math.inf)
    check("sparse_auto", fmt == "bsr" and type(op).__name__ == "BsrOperator"
          and h.converged and hc.converged and launches >= h.mvproducts
          and lam_err <= 1e-5,
          n=n, nnz=S.nnz, format=fmt, format_info=info,
          as_operator_s=convert_s, mvproducts=h.mvproducts, kernel_launches=launches, wall_s=wall,
          csr_mvproducts=hc.mvproducts, csr_wall_s=wall_csr,
          lam_err_vs_csr=lam_err)


def _cheb_case(torch, grid, dtype, gen):
    """Inputs of one Chebyshev step at `grid`: x, z on the card and the
    step's scalars from a degree-1000 scaled filter over the north star's
    interval shape (damp [5e-5, 1.0925], scale at 2.5e-7)."""
    from arnoldimethod_torch.transforms import ChebyshevFilterOperator
    from arnoldimethod_torch.models.operators import Stencil5Operator

    n = grid[0] * grid[1]
    op = Stencil5Operator(LAPLACE, grid, dtype=dtype, device="cuda")
    fop = ChebyshevFilterOperator(op, 5e-5, 1.0925, 1000, scale_point=2.5e-7)
    x = torch.randn(n, dtype=dtype, device="cuda", generator=gen)
    z = torch.randn(n, dtype=dtype, device="cuda", generator=gen)
    c = (fop.a + fop.b) / 2
    inv_e = 1.0 / ((fop.b - fop.a) / 2)
    p, q = fop.steps[10]
    return fop, x, z, c, inv_e, fop.first, p, q


def phase_cheb_kernel(torch):
    """The fused Chebyshev step against stencil5_cheb_plain on the card,
    then one whole degree-1000 filtered matvec both ways."""
    from arnoldimethod_torch.models.operators import Stencil5Operator
    from arnoldimethod_torch.ops import stencil
    from arnoldimethod_torch.transforms import ChebyshevFilterOperator

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for grid, dtype in (((3200, 3200), torch.float32),
                        ((1024, 1024), torch.float32),
                        ((1021, 1000), torch.float32),
                        ((256, 256), torch.float64)):
        _, x, z, c, inv_e, p0, p, q = _cheb_case(torch, grid, dtype, gen)
        kw = dict(coeffs=LAPLACE, grid=grid, c=c, inv_e=inv_e)
        eps = torch.finfo(dtype).eps
        xmax, zmax = x.abs().max().item(), z.abs().max().item()
        smax = sum(abs(v) for v in LAPLACE) + abs(c)
        n = grid[0] * grid[1]
        for mode in ("q0", "q", "alias"):
            pp, qq = (p0, 0.0) if mode == "q0" else (p, q)
            zz = None if mode == "q0" else z
            want = stencil.stencil5_cheb_plain(x, zz, LAPLACE, grid, c,
                                               inv_e, pp, qq)
            if mode == "alias":
                buf = z.clone()
                got = stencil.stencil5_cheb_step(x, buf, p=pp, q=qq, out=buf,
                                                 **kw)
                aliased = got.data_ptr() == buf.data_ptr()
            else:
                got = stencil.stencil5_cheb_step(x, zz, p=pp, q=qq, **kw)
                aliased = None
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            bound = 8 * eps * (abs(pp) * abs(inv_e) * smax * xmax
                               + abs(qq) * (0 if zz is None else zmax))
            ping = z.clone()

            def kernel():
                if mode == "alias":
                    return stencil.stencil5_cheb_step(x, ping, p=pp, q=qq,
                                                      out=ping, **kw)
                return stencil.stencil5_cheb_step(x, zz, p=pp, q=qq, **kw)

            def plain():
                return stencil.stencil5_cheb_plain(x, zz, LAPLACE, grid, c,
                                                   inv_e, pp, qq)

            ms, plain_ms = graph_ms(kernel), graph_ms(plain)
            nbytes = (2 if zz is None else 3) * n * x.element_size()
            # Instructions a point with FMAs: 5 for the stencil, 2 (q = 0)
            # or 3 for the recurrence.
            bound_ms, bound_by = roofline(
                nbytes, (7 if zz is None else 8) * n, str(dtype).split(".")[-1])
            res = {"grid": list(grid), "dtype": str(dtype).split(".")[-1],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None,
                   "mode": mode, "p": pp, "q": qq, "c": c, "inv_e": inv_e,
                   "max_abs_err": err, "bound": bound, "out_is_z": aliased,
                   "ms": ms, "plain_ms": plain_ms,
                   "slower_than_plain": ms > plain_ms,
                   "gbs": nbytes / ms / 1e6,
                   "plain_gbs": nbytes / plain_ms / 1e6}
            results.append(res)
            check("cheb_kernel", err <= bound and aliased is not False, **res)

    # One whole degree-1000 filtered matvec at the north star's grid, the
    # kernel's recurrence against the plain stencil + torch ops.
    grid = (3200, 3200)
    fop, x, *_ = _cheb_case(torch, grid, torch.float32, gen)
    plain_op = Stencil5Operator(LAPLACE, grid, dtype=torch.float32,
                                use_pallas=False, device="cuda")
    fplain = ChebyshevFilterOperator(plain_op, fop.a, fop.b, fop.degree,
                                     scale_point=fop.scale_point)
    before = stencil.KERNEL.cheb_launches
    y_k, y_p = fop.matvec(x), fplain.matvec(x)
    torch.cuda.synchronize()
    steps = stencil.KERNEL.cheb_launches - before
    rel = (torch.linalg.vector_norm(y_k - y_p)
           / torch.linalg.vector_norm(y_p)).item()
    ms = median_ms(lambda: fop.matvec(x), reps=5, warm=1)
    plain_ms = median_ms(lambda: fplain.matvec(x), reps=3, warm=1)
    check("cheb_kernel", steps == fop.degree and rel <= 1e-4
          and bool(torch.isfinite(y_k).all()),
          case="filter_matvec_deg1000_3200x3200_f32", kernel_steps=steps,
          rel_diff=rel, ms=ms, plain_ms=plain_ms,
          ms_per_step=ms / fop.degree, plain_ms_per_step=plain_ms / fop.degree)
    return results[2]  # 3200^2 f32, y written over z: the recurrence's mode


def phase_e2e10m(torch):
    """The north star at full size (bench.py's e2e_10m_nev100 recipe, its
    first configuration): nev=100 of the 10,240,000-row Laplacian."""
    import gc

    import numpy as np

    from arnoldimethod_torch import (
        ChebyshevFilterOperator,
        estimate_interval,
        partial_schur,
        rayleigh_ritz,
    )
    from arnoldimethod_torch.models.operators import Stencil5Operator
    from arnoldimethod_torch.ops import bsr, stencil

    N, nev, deg = 3200, 100, 1000
    lam1 = 0.130 * (2 - 2 * np.cos(np.pi * np.arange(1, N + 1) / (N + 1)))
    exact = np.sort(np.partition(np.add.outer(lam1, lam1).ravel(), nev)[:nev])
    op = Stencil5Operator(LAPLACE, (N, N), dtype=torch.float32, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    K = stencil.KERNEL
    K.launches = K.cheb_launches = bsr.KERNEL.launches = 0
    t0 = time.perf_counter()
    iv = estimate_interval(op, nev=nev, maxdim=120,
                           refine_degree=(100, 200, 400, 400))
    torch.cuda.synchronize()
    interval_s = time.perf_counter() - t0
    iv_launches = (K.launches, K.cheb_launches)
    fop = ChebyshevFilterOperator(op, iv.a, iv.b, deg, scale_point=iv.lo)
    t0 = time.perf_counter()
    d, h = partial_schur(fop, nev=nev, which="LM", tol=1e-7, mindim=nev,
                         maxdim=200, method="host")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    solve_launches = (K.launches - iv_launches[0],
                      K.cheb_launches - iv_launches[1])
    t0 = time.perf_counter()
    w, _, res = rayleigh_ritz(op, d.Q_rows, rows_layout=True,
                              return_vectors=False)
    torch.cuda.synchronize()
    rr_s = time.perf_counter() - t0
    launches = {"stencil5": K.launches, "stencil5_cheb": K.cheb_launches,
                "bsr": bsr.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    w = np.sort(np.asarray(w).real)
    err = (float(np.max(np.abs(w[:nev] - exact))) if w.size >= nev
           else math.inf)
    max_res = float(np.max(res[:nev]))
    info = dict(
        n=N * N, interval={"a": iv.a, "b": iv.b, "lo": iv.lo},
        interval_s=interval_s, solve_s=solve_s, rr_s=rr_s,
        wall_s=interval_s + solve_s + rr_s, restarts=h.restarts,
        filtered_matvecs=h.mvproducts, A_matvecs=h.mvproducts * deg,
        nconverged=h.nconverged, converged=h.converged, max_resid=max_res,
        eig_err=err, interval_launches={"stencil5": iv_launches[0],
                                        "stencil5_cheb": iv_launches[1]},
        solve_launches={"stencil5": solve_launches[0],
                        "stencil5_cheb": solve_launches[1]},
        launches=launches, timings=h.timings, host_syncs=h.host_syncs,
        dense_layer=h.dense_layer, peak_mem_bytes=peak,
        resident_before_bytes=resident,
        jax_tpu_record={"source": "BENCH_r05.json (JAX on a TPU)",
                        "restarts": 1, "filtered_matvecs": 200,
                        "eig_err": 1.145e-8, "max_resid": 1.322e-6,
                        "wall_s": 243},
    )
    check("e2e10m", h.converged and h.nconverged >= nev and err <= 1e-7
          and max_res <= 1e-5 and solve_launches[1] == h.mvproducts * deg
          and solve_launches[0] == 0, **info)
    return launches["stencil5_cheb"]


def phase_shiftinv(torch):
    """The reference's config 4 (bench/partial_schur.jl:37-52): n = 6,000
    tridiagonal (-1, 2, -1.001), shift-invert at sigma = 0, nev=10, :LM."""
    import numpy as np

    from arnoldimethod_torch import TridiagonalShiftInvertOperator, partial_schur

    n = 6000
    dl, d, du = np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.001)
    kw = dict(nev=10, which="LM", tol=1e-7, mindim=11, maxdim=22,
              method="host")
    t0 = time.perf_counter()
    si = TridiagonalShiftInvertOperator.build(dl, d, du, sigma=0.0,
                                              dtype=np.float32, device="cuda")
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec, h = partial_schur(si, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lams = 1.0 / dec.eigenvalues.real
    exact = 2.0 + 2.0 * np.sqrt(1.001) * np.cos(
        np.arange(1, n + 1) * np.pi / (n + 1))
    eig_err = (max(np.min(np.abs(exact - lam)) for lam in lams) / 4.003
               if lams.size else math.inf)
    # float64 from one v1, on the card and on the CPU.
    v1 = np.random.default_rng(1).standard_normal(n)
    counts = {}
    for dev in ("cuda", "cpu"):
        si64 = TridiagonalShiftInvertOperator.build(dl, d, du, sigma=0.0,
                                                    device=dev)
        _, h64 = partial_schur(si64, v1=v1, **kw)
        counts[dev] = (h64.mvproducts, h64.converged)
    check("shiftinv", h.converged and h.nconverged >= 10 and eig_err <= 1e-6
          and counts["cuda"] == counts["cpu"] and counts["cuda"][1],
          n=n, refine=si.refine, factor_s=factor_s, wall_s=wall,
          mvproducts=h.mvproducts, restarts=h.restarts,
          nconverged=h.nconverged, eig_err=eig_err,
          f64_mvproducts_cuda=counts["cuda"][0],
          f64_mvproducts_cpu=counts["cpu"][0],
          jax_record_mvproducts={"value": 28,
                                 "source": "README, JAX package"})


def phase_conv1m(torch):
    """The periodic convection-diffusion circulant at n = 1,048,576
    through the FFT shift-invert (bench.py's conv_1m_nonsym recipe)."""
    import numpy as np

    from arnoldimethod_torch import (
        CirculantShiftInvertOperator,
        partial_schur,
        power_bound,
        rayleigh_ritz,
    )
    from arnoldimethod_torch.models import convection_diffusion_periodic_2d

    N, s, cx, cy = 1024, 0.13, 0.15, 0.08
    op = convection_diffusion_periodic_2d(N, cx=cx, cy=cy, scale=s,
                                          device="cuda")
    t0 = time.perf_counter()
    sigma = power_bound(op)
    gen = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn(N * N, dtype=torch.float32, device="cuda", generator=gen)
    for _stage in range(4):
        si = CirculantShiftInvertOperator.build(op, sigma)
        for _ in range(30):
            w = si.matvec(v)
            v = w / torch.linalg.vector_norm(w)
        Av = op.matvec(v)
        lam_hat = float(torch.dot(v, Av))
        r = float(torch.linalg.vector_norm(Av - lam_hat * v))
        sigma = lam_hat + max(4 * r, 0.05 * (sigma - lam_hat), 1e-7)
    torch.cuda.synchronize()
    sigma_s = time.perf_counter() - t0
    si = CirculantShiftInvertOperator.build(op, sigma)
    t0 = time.perf_counter()
    dec, h = partial_schur(si, nev=12, which="LM", tol=1e-7, mindim=18,
                           maxdim=36, method="host", restarts=300)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w, X, res = rayleigh_ritz(op, dec.Q)
    torch.cuda.synchronize()
    rr_s = time.perf_counter() - t0
    th = 2 * np.pi * np.arange(N) / N
    se = (s * ((2 - 2 * np.cos(th))[:, None] + (2 - 2 * np.cos(th))[None, :]
               + 2j * (cx * np.sin(th)[:, None] + cy * np.sin(th)[None, :]))
          ).ravel()
    w = np.asarray(w)
    acc = float(max(np.abs(se - lam).min() for lam in w))
    top8 = se[np.argsort(-np.abs(se))][:8]
    cov = float(max(np.abs(w - t).min() for t in top8))
    pairs = int(np.sum(w.imag > 1e-9))
    check("conv1m", h.converged and acc <= 1e-4 and pairs >= 1
          and X.is_complex() and X.shape == (N * N, w.size),
          n=N * N, sigma=sigma, sigma_s=sigma_s, solve_s=solve_s, rr_s=rr_s,
          mvproducts=h.mvproducts, restarts=h.restarts,
          nconverged=h.nconverged, max_resid=float(np.max(res)),
          eig_acc=acc, top8_coverage=cov, complex_pairs=pairs,
          jax_tpu_record={"source": "BENCH_r05.json (JAX on a TPU)",
                          "mvproducts": 114, "restarts": 7,
                          "complex_pairs": 6, "max_resid": 4.6e-5})


# The H100's published memory rate (NVIDIA's data sheet, SXM, 700 W).
PEAK_BYTES_S = 3.35e12
# Lane-instructions a clock an SM issues outside the tensor cores: 128 in
# float32, 64 in float64 (an FMA is one instruction, as an add or a
# multiply is; the double-word kernels issue no FMA and use no tensor
# core).  The rate is that times the SMs times the SM clock nvidia-smi
# reports as clocks.max.sm (phase_device sets PEAK_OPS_S).
LANES = {"float32": 128, "float64": 64}
PEAK_OPS_S = {}
# nvidia-smi's clocks.max.sm in MHz (phase_device sets it).
CLOCK_MHZ = {}
# Operations of the double-word steps of ops/df32.py with every operand
# split beforehand, each split (4) counted once an operand: two_prod 9,
# df_mul 16, df_scale 14, df_add 11 (17, 24, 22 with both splits).
SPLIT, DF_MUL, DF_SCALE, DF_ADD = 4, 16, 14, 11
# df_normalize's scalar work, once a launch: three df_sqrt (a root, two_prod
# of r with its splits 17, df_add 11, an add, a multiply and a divide,
# quick_two_sum 3: 35 each), df_inv (a divide, df_mul 24, df_add 11,
# df_scale 22, df_add 11: 69), two ETA products and two comparisons.
NORMALIZE_SCALAR_OPS = 3 * 35 + 69 + 4


def set_peak_ops(torch, clock_mhz):
    """PEAK_OPS_S from the SM count and the SM clock in MHz."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for word, lanes in LANES.items():
        PEAK_OPS_S[word] = sms * lanes * clock_mhz * 1e6
    return sms


def roofline(nbytes, ops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    lane-instructions over the issue rate of `dtype`."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def df_ops(name, n, rows=1, m1=1):
    """The fewest operations of a double-word kernel's bitwise result, each
    operand split once: `rows` rows of length n (the basis change: `rows`
    outputs over m1 rows).  df_sum's tree adds N - 1 pairs a row, N = n
    padded to a power of two."""
    N = 1 << max(0, n - 1).bit_length()
    if name == "df_project":
        return rows * n * DF_MUL + rows * (N - 1) * DF_ADD + SPLIT * (rows + 1) * n
    if name == "df_project_norm":
        return n * (DF_MUL + SPLIT) + (N - 1) * DF_ADD
    if name == "df_axpy":
        return rows * n * (DF_MUL + DF_ADD) + SPLIT * (rows * n + rows)
    if name == "df_axpy_norm":
        # The axpy, then df_sum's tree over the n squares of the result.
        return df_ops("df_axpy", n, rows) + n * DF_MUL + (N - 1) * DF_ADD
    if name == "df_normalize":
        # The product w * (1/||w||) (w split a point, the scalar once), the
        # H column's m1 df_add after a second pass and the scalar work.
        return (n * (DF_MUL + SPLIT) + SPLIT + m1 * DF_ADD
                + NORMALIZE_SCALAR_OPS)
    if name == "df_basis_change":
        return rows * m1 * n * (DF_MUL + DF_ADD) + SPLIT * m1 * (n + rows)
    if name == "stencil5_df":
        # Five scaled points and four adds, x split once a point (the
        # coefficients' splits are made on the host).
        return n * (5 * DF_SCALE + 4 * DF_ADD + SPLIT)
    raise KeyError(name)


def bitwise(pairs):
    """True when every (a, b) pair of float tensors has equal bits (signed
    zeros included)."""
    import torch

    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return all(a.shape == b.shape and a.dtype == b.dtype
               and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
               for a, b in pairs)


def same_bits(xs, ys):
    """Equal bits of each pair of float tensors, equal values of each pair
    of integer ones."""
    import torch

    return all(bitwise([(a, b)]) if a.is_floating_point() else torch.equal(a, b)
               for a, b in zip(xs, ys))


def _two_prod_exact(torch, dtype, gen):
    """two_prod's exactness on the card: the plain version (torch ops) on
    65,536 random pairs and the df_axpy kernel on 0 - (b, 0) * (a, 0) for
    8 scalars b (df_mul's two_prod, then exact renormalizations); p + e
    must equal a * b exactly (float64 arithmetic for float32 words, exact
    rationals on 2,000 pairs for float64 words)."""
    from fractions import Fraction

    from arnoldimethod_torch.ops import df, df32

    a = torch.randn(1 << 16, dtype=dtype, device="cuda", generator=gen)
    b = torch.randn(1 << 16, dtype=dtype, device="cuda", generator=gen)
    pairs = [(a, b, *df32.two_prod(a, b))]
    zero = torch.zeros_like(a)
    for s in b[:8]:
        ph, pl = df.df_axpy(zero, zero, s.reshape(1), zero[:1], a[None],
                            zero[None], 1)
        pairs.append((a, s.expand_as(a), -ph, -pl))
    bad = 0
    for x, y, p, e in pairs:
        if dtype == torch.float32:
            bad += int((p.double() + e.double() != x.double() * y.double()).sum())
        else:
            xs, ys, ps, es = (t[:2000].cpu().tolist() for t in (x, y, p, e))
            bad += sum(Fraction(pp) + Fraction(ee) != Fraction(xx) * Fraction(yy)
                       for xx, yy, pp, ee in zip(xs, ys, ps, es))
    return bad


def _df_case(torch, grid, dtype, gen, time_plain):
    """Each double-word kernel against its plain version on one shape: a
    61-row basis over the grid's n points, both words random."""
    from arnoldimethod_torch.ops import df

    ny, nx = grid
    n, m1 = ny * nx, 61
    rows = m1 - 1
    item = torch.finfo(dtype).bits // 8
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)

    def pair(*shape):
        h = torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)
        return h, torch.randn(*shape, dtype=dtype, device="cuda",
                              generator=gen) * lo

    Vh, Vl = pair(m1, n)
    wh, wl = pair(n)
    hh, hl = pair(m1)
    Qh, Ql = pair(m1, m1)
    Oh, Ol = torch.empty_like(Vh), torch.empty_like(Vl)
    ah, al = pair(m1)
    w2 = pair(n)
    coeffs = (4.0, -1.0 - 0.5039, -1.0 + 0.5039, -1.0, -1.0)
    # df_normalize's step j = rows - 1 with its second pass taken and no
    # breakdown (most of config 3's steps), each form into outputs of its
    # own.
    norm_args = normalize_inputs(torch, (wh, wl), w2, (hh, hl), (ah, al),
                                 "second")
    norm_k, norm_p = (normalize_outputs(torch, wh, m1) for _ in range(2))
    calls = {
        "df_project": (
            lambda acc: df.df_project(Vh, Vl, wh, wl, rows, acc),
            lambda acc: df.df_project_plain(Vh, Vl, wh, wl, rows, acc),
            (rows + 1) * n * 2 * item + 4 * m1 * item,
            df_ops("df_project", n, rows)),
        "df_project_norm": (
            lambda acc: df.df_project(wh[None], wl[None], wh, wl, 1),
            lambda acc: df.df_project_plain(wh[None], wl[None], wh, wl, 1),
            2 * n * item, df_ops("df_project_norm", n)),
        "df_axpy": (
            lambda acc: df.df_axpy(wh, wl, hh, hl, Vh, Vl, rows),
            lambda acc: df.df_axpy_plain(wh, wl, hh, hl, Vh, Vl, rows),
            (rows + 2) * n * 2 * item, df_ops("df_axpy", n, rows)),
        "df_axpy_norm": (
            lambda acc: _flat(df.df_axpy(wh, wl, hh, hl, Vh, Vl, rows, True)),
            lambda acc: _flat(df.df_axpy_plain(wh, wl, hh, hl, Vh, Vl, rows,
                                               True)),
            axpy_norm_bytes(n, rows, item), df_ops("df_axpy_norm", n, rows)),
        "df_normalize": (
            lambda acc: normalize_call(df.df_normalize, norm_args, norm_k,
                                       rows - 1),
            lambda acc: normalize_call(df.df_normalize_plain, norm_args,
                                       norm_p, rows - 1),
            normalize_bytes(n, m1, item), df_ops("df_normalize", n, m1=m1)),
        "df_basis_change": (
            lambda acc: df.df_basis_change(Vh, Vl, Qh, Ql, out=(Oh, Ol)),
            lambda acc: df.df_basis_change_plain(Vh, Vl, Qh, Ql),
            basis_bytes(m1, m1, n, item), df_ops("df_basis_change", n, m1, m1)),
        "stencil5_df": (
            lambda acc: df.stencil5_df(wh, wl, coeffs, grid),
            lambda acc: df.stencil5_df_plain(wh, wl, coeffs, grid),
            2 * n * 2 * item, df_ops("stencil5_df", n)),
    }
    out = {}
    word = str(dtype).split(".")[-1]
    case = {(256, 256): "config3", (1024, 1024): "1m"}.get(grid, "odd")
    for name, (kernel, plain, nbytes, ops) in calls.items():
        acc_k, acc_p = (ah.clone(), al.clone()), (ah.clone(), al.clone())
        got = kernel(acc_k if name == "df_project" else None)
        want = plain(acc_p if name == "df_project" else None)
        torch.cuda.synchronize()
        same = bitwise(zip(got, want))
        if name == "df_project":
            same = same and bitwise(zip(acc_k, acc_p))
        err = max((a.double() - b.double()).abs().max().item()
                  for a, b in zip(got, want))
        ms = graph_ms(lambda: kernel(None))
        bound_ms, bound_by = roofline(nbytes, ops, word)
        res = {"bitwise": same, "max_abs_err": err, "ms": ms,
               "gbs": nbytes / ms / 1e6, "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes_bound_ms": nbytes / PEAK_BYTES_S * 1e3,
               "share_of_bound": bound_ms / ms, "bytes": nbytes, "ops": ops}
        was = TWO_PASS_PROJECT_MS.get((name, case, word))
        if was is not None:
            res["two_pass_ms"] = was
            res["slower_than_two_pass"] = ms > was
        res.update(against_earlier(name, case, word, ms))
        if name == "df_normalize":
            res.update(normalize_record(case, word, ms))
        if time_plain:
            res["plain_ms"] = median_ms(lambda: plain(None), reps=3, warm=1)
        out[name] = res
    return out


# df_project's device ms as the two-pass kernel this one replaced took them
# (PERF.md §6, run F, NVIDIA H100 80GB
# HBM3, 700.00 W), by (form, case, word): the times this design is held to.
TWO_PASS_PROJECT_MS = {
    ("df_project", "config3", "float32"): 0.0301200,
    ("df_project", "1m", "float32"): 0.3943,
    ("df_project", "odd", "float32"): 0.4008,
    ("df_project", "config3", "float64"): 0.0434,
    ("df_project", "1m", "float64"): 0.5902,
    ("df_project", "odd", "float64"): 0.6068,
    ("df_project_norm", "config3", "float32"): 0.0161296,
    ("df_project_norm", "1m", "float32"): 0.1627,
    ("df_project_norm", "odd", "float32"): 0.1583,
    ("df_project_norm", "config3", "float64"): 0.0172,
    ("df_project_norm", "1m", "float64"): 0.1864,
    ("df_project_norm", "odd", "float64"): 0.1849,
}


# df_axpy's device ms with the earlier kernel (a thread a
# column; PERF.md §6, its last run, NVIDIA H100 80GB
# HBM3, 700.00 W), by (form, case, word); the fused form against that axpy
# plus the one-row df_project of its result: no case may be slower now.
COLUMN_AXPY_MS = {
    ("df_axpy", "config3", "float32"): 0.0197944,
    ("df_axpy", "1m", "float32"): 0.2037,
    ("df_axpy", "odd", "float32"): 0.2093,
    ("df_axpy", "config3", "float64"): 0.0447,
    ("df_axpy", "1m", "float64"): 0.4166,
    ("df_axpy", "odd", "float64"): 0.4018,
    ("df_axpy_norm", "config3", "float32"): 0.0197944 + 0.0054288,
    ("df_axpy_norm", "1m", "float32"): 0.2037 + 0.0113,
    ("df_axpy_norm", "odd", "float32"): 0.2093 + 0.0112,
    ("df_axpy_norm", "config3", "float64"): 0.0447 + 0.0058,
    ("df_axpy_norm", "1m", "float64"): 0.4166 + 0.0186,
    ("df_axpy_norm", "odd", "float64"): 0.4018 + 0.0187,
}


# df_basis_change's and stencil5_df's device ms before their redesign
# (PERF.md §6, run F, NVIDIA H100 80GB HBM3, 700.00 W), by (kernel,
# case, word): no case may be slower now.  TARGET_MS: the redesigns' aims.
RUN_F_MS = {
    ("df_basis_change", "config3", "float32"): 0.4302696,
    ("df_basis_change", "1m", "float32"): 6.512,
    ("df_basis_change", "odd", "float32"): 6.331,
    ("df_basis_change", "config3", "float64"): 0.657,
    ("df_basis_change", "1m", "float64"): 9.927,
    ("df_basis_change", "odd", "float64"): 9.685,
    ("stencil5_df", "config3", "float32"): 0.0057136,
    ("stencil5_df", "1m", "float32"): 0.0110,
    ("stencil5_df", "odd", "float32"): 0.0110,
    ("stencil5_df", "config3", "float64"): 0.0063,
    ("stencil5_df", "1m", "float64"): 0.0162,
    ("stencil5_df", "odd", "float64"): 0.0157,
}
TARGET_MS = {
    ("df_basis_change", "config3", "float32"): 0.26,
    ("df_basis_change_rows31", "config3", "float32"): 0.14,
    ("df_basis_change", "1m", "float32"): 4.1,
    ("df_basis_change", "config3", "float64"): 0.52,
    ("df_basis_change", "1m", "float64"): 8.2,
    ("stencil5_df", "config3", "float32"): 0.0032,
    ("stencil5_df", "config3", "float64"): 0.0036,
    ("stencil5_df", "1m", "float32"): 0.0070,
    ("stencil5_df", "1m", "float64"): 0.0130,
    ("stencil5_df", "odd", "float32"): 0.0070,
    ("stencil5_df", "odd", "float64"): 0.0130,
    ("df_axpy", "config3", "float32"): 0.0130,
    ("df_axpy", "config3", "float64"): 0.026,
    ("df_axpy_norm", "config3", "float32"): 0.0150,
}


def against_earlier(name, case, word, ms):
    """The earlier kernel's time (RUN_F_MS, COLUMN_AXPY_MS) and the target
    of a case, where there are any."""
    out = {}
    was = RUN_F_MS.get((name, case, word), COLUMN_AXPY_MS.get((name, case, word)))
    if was is not None:
        out.update(earlier_ms=was, slower_than_earlier=ms > was)
    aim = TARGET_MS.get((name, case, word))
    if aim is not None:
        out.update(target_ms=aim, meets_target=ms <= aim)
    return out


def _flat(pairs):
    """((outh, outl), (sh, sl)) as (outh, outl, sh, sl)."""
    return (*pairs[0], *pairs[1])


def axpy_norm_bytes(n, rows, item):
    """df_axpy's fused form: V's rows and w read, the result written (both
    words), the plan's partials written and the sum's two words."""
    from arnoldimethod_torch.ops import df

    M = df.axpy_plan(n, rows, item, True).M
    return (rows + 2) * n * 2 * item + 2 * M * item + 2 * item


def basis_bytes(m1, rows, n, item):
    """df_basis_change's bytes: V read (both words), its first `rows` rows
    written, Q's m1 x rows entries read."""
    return ((m1 + rows) * n + m1 * rows) * 2 * item


# df_normalize's cases: the hi words of the sums r2, s1 and s2 (each lo a
# small fraction of its hi), r2 None for the one-sum form; "zero" has w = 0
# as well (df_sqrt(0) = (0, 0): a breakdown, no NaN).
NORMALIZE_SUMS = {
    "one_sum": (None, 0.81, None),
    "first": (3.0, 2.25, 1.44),
    "second": (9.0, 2.25, 1.44),
    "second_breakdown": (9.0, 2.25, 0.25),
    "zero": (0.0, 0.0, 0.0),
}
# df_mul_by's device ms, the kernel df_normalize replaced, at config 3's
# 65,536 float32 pairs (PERF.md §6's kernel table, NVIDIA H100 80GB HBM3,
# 700.00 W): a record, not measured here.
MUL_BY_RECORD_MS = {("config3", "float32"): 0.0022880}
MUL_BY_IS = ("record of df_mul_by in PERF.md §6 (NVIDIA H100 80GB HBM3, "
             "700 W); not measured in this run")


def normalize_inputs(torch, w1, w2, h1, c, case):
    """(w1, s1, (r2, w2, s2, h1, c) or None): df_normalize's operands for
    one of NORMALIZE_SUMS, the sums as 0-dim words on w1's device."""
    lo = 2.0 ** (-27 if w1[0].dtype == torch.float32 else -56)

    def word_pair(v):
        return tuple(torch.tensor(x, dtype=w1[0].dtype, device=w1[0].device)
                     for x in (v, v * lo))

    r2, s1, s2 = NORMALIZE_SUMS[case]
    if r2 is None:
        return w1, word_pair(s1), None
    return w1, word_pair(s1), (word_pair(r2), w2, word_pair(s2), h1, c)


def normalize_outputs(torch, like, m1):
    """A row pair, an (m1, m1 - 1) Hessenberg pair and m1 - 1 flags, zero."""
    return ((torch.zeros_like(like), torch.zeros_like(like)),
            tuple(torch.zeros(m1, m1 - 1, dtype=like.dtype, device=like.device)
                  for _ in range(2)),
            torch.zeros(m1 - 1, dtype=like.dtype, device=like.device))


def normalize_call(fn, args, outs, j):
    """fn (df_normalize or its plain version) on `args` into `outs`, step
    j; returns the row pair, the H pair and the flags."""
    from arnoldimethod_torch.ops import df

    w1, s1, parts = args
    out, H, flags = outs
    step = None if parts is None else df.DgksStep(*parts, H, j, flags)
    fn(w1, s1, out, step)
    return (*out, *H, flags)


def normalize_bytes(n, m1, item):
    """df_normalize's step form: the chosen pass's w read and the row
    written (16 bytes an element in float32 words: the other pass's w is
    never read), both coefficient vectors read and the H column written,
    six sum words read and the flag written."""
    return (4 * n + 6 * m1 + 7) * item


def normalize_record(case, word, ms):
    """df_mul_by's record beside df_normalize's time, labelled as a record
    that this run did not measure."""
    was = MUL_BY_RECORD_MS.get((case, word))
    if was is None:
        return {}
    return {"df_mul_by_record_ms": was, "df_mul_by_record_is": MUL_BY_IS,
            "slower_than_df_mul_by_record": ms > was}


def _normalize_forms(torch, dtype, gen):
    """df_normalize against its plain version on the card and on a CPU
    copy of the inputs, bitwise (row, H pair, flags), at 65,536 and
    1,048,576 rows, with every operand 16-byte aligned and with w and the
    row one word off, in every case of NORMALIZE_SUMS; ms (CUDA graph of
    20 calls) and bounds of the step form with the second pass taken."""
    from arnoldimethod_torch.ops import df

    word = str(dtype).split(".")[-1]
    item = torch.finfo(dtype).bits // 8
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
    m1 = 61

    def pair(*shape):
        h = torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)
        return h, torch.randn(*shape, dtype=dtype, device="cuda",
                              generator=gen) * lo

    def cpu(x):
        return (None if x is None else x.cpu() if isinstance(x, torch.Tensor)
                else tuple(cpu(t) for t in x))

    out = []
    h1, c = pair(m1), pair(m1)
    for n in (1 << 16, 1 << 20):
        w1, w2 = pair(n + 1), pair(n + 1)
        for offset in (0, 1):
            at = slice(offset, n + offset)
            for case in NORMALIZE_SUMS:
                a1, a2 = ((w[0][at], w[1][at]) for w in (w1, w2))
                if case == "zero":
                    a1 = a2 = (torch.zeros(n, dtype=dtype, device="cuda"),) * 2
                args = normalize_inputs(torch, a1, a2, h1, c, case)
                outs = [normalize_outputs(torch, w1[0], m1) for _ in range(3)]
                rows = [(o[0][0][at], o[0][1][at]) for o in outs]
                outs = [(r, *o[1:]) for r, o in zip(rows, outs)]
                got = normalize_call(df.df_normalize, args, outs[0], m1 - 2)
                want = normalize_call(df.df_normalize_plain, args, outs[1],
                                      m1 - 2)
                host = normalize_call(df.df_normalize_plain, cpu(args),
                                      cpu(outs[2]), m1 - 2)
                torch.cuda.synchronize()
                res = {"n": n, "offset_words": offset, "case": case,
                       "bitwise": bitwise(zip(got, want)) and bitwise(
                           zip((t.cpu() for t in got), host)),
                       "finite": all(bool(torch.isfinite(t).all())
                                     for t in got),
                       "flag": float(got[4][m1 - 2])}
                if case == "second":
                    nbytes = normalize_bytes(n, m1, item)
                    ms = graph_ms(lambda: normalize_call(
                        df.df_normalize, args, outs[0], m1 - 2))
                    bound_ms, bound_by = roofline(
                        nbytes, df_ops("df_normalize", n, m1=m1), word)
                    res.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                               share_of_bound=bound_ms / ms,
                               **normalize_record(
                                   "config3" if (n, offset) == (
                                       1 << 16, 0) else None, word, ms))
                out.append(res)
    return out


def _df_windows(torch, dtype, gen):
    """df_basis_change over a 61 x 65,536 basis at rows 31, 46 and 61, into
    new tensors and in place (V itself, the restart's form), and
    stencil5_df at 64^2 (its launch floor): each bitwise against the plain
    version, with its plan, ms (CUDA graph of 20 calls), bound and the
    plain version's ms."""
    from arnoldimethod_torch.ops import df

    word = str(dtype).split(".")[-1]
    item = torch.finfo(dtype).bits // 8
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)

    def pair(*shape):
        h = torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)
        return h, torch.randn(*shape, dtype=dtype, device="cuda",
                              generator=gen) * lo

    m1, n = 61, 65536
    Vh, Vl = pair(m1, n)
    Qh, Ql = pair(m1, m1)
    Oh, Ol = torch.empty_like(Vh), torch.empty_like(Vl)
    out = []
    for rows in (31, 46, 61):
        want = df.df_basis_change_plain(Vh, Vl, Qh, Ql, rows)
        got = df.df_basis_change(Vh, Vl, Qh, Ql, rows)
        Wh, Wl = Vh.clone(), Vl.clone()
        df.df_basis_change(Wh, Wl, Qh, Ql, rows, out=(Wh, Wl))
        torch.cuda.synchronize()
        in_place = (bitwise(zip((Wh[:rows], Wl[:rows]), want)) and bitwise(
            [(Wh[rows:], Vh[rows:]), (Wl[rows:], Vl[rows:])]))
        same = bitwise(zip(got, want)) and in_place
        ms = graph_ms(lambda: df.df_basis_change(Vh, Vl, Qh, Ql, rows,
                                                 out=(Oh, Ol)))
        nbytes = basis_bytes(m1, rows, n, item)
        bound_ms, bound_by = roofline(
            nbytes, df_ops("df_basis_change", n, rows, m1), word)
        name = "df_basis_change" + ("" if rows == m1 else f"_rows{rows}")
        out.append({"kernel": "df_basis_change", "m1": m1, "n": n,
                    "rows": rows, "plan": df.basis_plan(m1, n, rows, item)._asdict(),
                    "bitwise": same, "in_place_bitwise": in_place, "ms": ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "share_of_bound": bound_ms / ms,
                    "plain_ms": median_ms(lambda: df.df_basis_change_plain(
                        Vh, Vl, Qh, Ql, rows), reps=3, warm=1),
                    **against_earlier(name, "config3", word, ms)})
    grid = (64, 64)
    xh, xl = pair(64 * 64)
    coeffs = (4.0, -1.0 - 0.5039, -1.0 + 0.5039, -1.0, -1.0)
    got = df.stencil5_df(xh, xl, coeffs, grid)
    want = df.stencil5_df_plain(xh, xl, coeffs, grid)
    torch.cuda.synchronize()
    ms = graph_ms(lambda: df.stencil5_df(xh, xl, coeffs, grid))
    bound_ms, bound_by = roofline(2 * 64 * 64 * 2 * item,
                                  df_ops("stencil5_df", 64 * 64), word)
    out.append({"kernel": "stencil5_df", "grid": list(grid),
                "plan": df.stencil_plan(*grid, item)._asdict(),
                "bitwise": bitwise(zip(got, want)), "ms": ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms,
                "plain_ms": median_ms(lambda: df.stencil5_df_plain(
                    xh, xl, coeffs, grid), reps=3, warm=1)})
    return out


# df_rank_sum's shapes: k = 62 (a step's m + 2 at config 3's maxdim 60) at
# 1, 2, 3, 4 and 8 ranks, and k = 1 (the step's {s2}) at the two the main
# path runs (sharded_ext_p1, sharded_ext_p2).
RANK_SUM_SHAPES = ((1, 62), (2, 62), (3, 62), (4, 62), (8, 62), (1, 1),
                   (2, 1))


def rank_sum_bytes(P, k, item, acc):
    """df_rank_sum's bytes: the P k pairs read, the k pairs written, and
    with acc its k pairs read and written."""
    return (P * k * 2 + 2 * k + (4 * k if acc else 0)) * item


def rank_sum_ops(P, k, acc):
    """df_rank_sum's operations: P' - 1 df_adds a coefficient (P padded to
    a power of two), and one more with acc."""
    width = 1 << max(0, P - 1).bit_length()
    return k * (width - 1 + (1 if acc else 0)) * DF_ADD


def _rank_sum_cases(torch, dtype, gen):
    """df_rank_sum against df_rank_sum_plain on the card, bitwise, on a
    gathered (P, 2k) buffer (each rank's hi words, then its lo words, as
    parallel/comm.py lays it out) at RANK_SUM_SHAPES, with and without acc;
    the kernel's ms (a graph of 20 calls), the plain version's (CUDA
    events) and the bound."""
    from arnoldimethod_torch.ops import df

    word = str(dtype).split(".")[-1]
    item = torch.finfo(dtype).bits // 8
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
    out = []
    for P, k in RANK_SUM_SHAPES:
        scale = 2.0 ** torch.randint(-20, 20, (P, k), device="cuda",
                                     generator=gen).to(dtype)
        hi = torch.randn(P, k, dtype=dtype, device="cuda", generator=gen) * scale
        parts = torch.cat((hi, hi * lo * torch.rand(
            P, k, dtype=dtype, device="cuda", generator=gen)), dim=1)
        ah = torch.randn(k, dtype=dtype, device="cuda", generator=gen)
        a0 = (ah, ah * lo)
        for acc in (False, True):
            acc_k = (a0[0].clone(), a0[1].clone()) if acc else None
            acc_p = (a0[0].clone(), a0[1].clone()) if acc else None
            got = df.df_rank_sum(parts[:, :k], parts[:, k:], acc_k)
            want = df.df_rank_sum_plain(parts[:, :k], parts[:, k:], acc_p)
            torch.cuda.synchronize()
            same = bitwise(zip(got, want)) and (
                not acc or bitwise(zip(acc_k, acc_p)))
            err = max((a.double() - b.double()).abs().max().item()
                      for a, b in zip(got, want))
            nbytes = rank_sum_bytes(P, k, item, acc)
            bound_ms, bound_by = roofline(nbytes, rank_sum_ops(P, k, acc), word)
            res = {"dtype": word, "P": P, "k": k, "acc": acc,
                   "bitwise": same, "max_abs_err": err}
            if not acc:
                ms = graph_ms(lambda: df.df_rank_sum(parts[:, :k],
                                                     parts[:, k:]))
                res.update(
                    ms=ms, plain_ms=median_ms(lambda: df.df_rank_sum_plain(
                        parts[:, :k], parts[:, k:]), reps=10, warm=2),
                    bound_ms=bound_ms, bound_by=bound_by,
                    share_of_bound=bound_ms / ms, bytes=nbytes,
                    library_ms=None)
            out.append(res)
    return out


# The gathered forms' ranks at config 3's shapes (df_axpy_gathered and
# df_normalize's step form against df_rank_sum and the form they replace),
# and the ranks at which the fold's prologue is timed.
GATHERED_RANKS = (1, 2, 3, 8)
PROLOGUE_RANKS = (1, 2, 8, 64, 256)


def _gathered_record(torch, dtype, gen, P, k, total=None):
    """A gathered record of P ranks' partials of k coefficients, laid out
    as parallel/comm.py's gather_partials lays it out: mixed magnitudes
    and signs, or, with `total`, P positive parts of about total (a sum of
    squares)."""
    from arnoldimethod_torch.ops import df

    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
    if total is None:
        scale = 2.0 ** torch.randint(-20, 20, (P, k), device="cuda",
                                     generator=gen).to(dtype)
        hi = torch.randn(P, k, dtype=dtype, device="cuda", generator=gen) * scale
    else:
        hi = total / P * (1 + 0.01 * torch.rand(P, k, dtype=dtype,
                                                device="cuda", generator=gen))
    parts = torch.cat((hi, hi * lo * torch.rand(
        P, k, dtype=dtype, device="cuda", generator=gen)), dim=1)
    return df.Gathered(parts.contiguous(), k, (0, 1) if k > 1 else (0,))


def gathered_axpy_bytes(n, rows, P, k, item):
    """df_axpy_gathered's bytes: the fused form's, the record's P k pairs
    read and its k sums written."""
    return axpy_norm_bytes(n, rows, item) + rank_sum_bytes(P, k, item, False)


def _gathered_cases(torch, dtype, gen):
    """df_axpy's gathered form (fused norm, a step's {r2, h1} record of
    k = 62 over a 61 x 65,536 basis, rows 60) and df_normalize's step form
    with a gathered s2 (the second pass taken), at GATHERED_RANKS: each
    bitwise against df_rank_sum followed by the form it replaces (both
    kernels on the card) and against its plain version; ms of each (a
    graph of 20 calls) beside the pair's, the bound, and the plain
    version's ms (float32, P = 1 and 2)."""
    from arnoldimethod_torch.ops import df

    word = str(dtype).split(".")[-1]
    item = torch.finfo(dtype).bits // 8
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
    n, m1, rows = 1 << 16, 61, 60
    k = m1 + 1

    def pair(*shape):
        h = torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)
        return h, torch.randn(*shape, dtype=dtype, device="cuda",
                              generator=gen) * lo

    V, w, w2, h1, c = pair(m1, n), pair(n), pair(n), pair(m1), pair(m1)
    r2, s1 = (tuple(torch.tensor(v * f, dtype=dtype, device="cuda")
                    for f in (1.0, lo)) for v in (9.0, 2.25))
    out = []
    for P in GATHERED_RANKS:
        g = _gathered_record(torch, dtype, gen, P, k)

        def gathered():
            (o, s), folded = df.df_axpy_gathered(*w, g, *V, rows, True)
            return (*o, *s, *folded)

        def replaced():
            sh, sl = df.df_rank_sum(g.hi, g.lo)
            o, s = df.df_axpy(*w, sh[1:], sl[1:], *V, rows, True)
            return (*o, *s, sh, sl)

        def plain():
            (o, s), folded = df.df_axpy_gathered_plain(*w, g, *V, rows, True)
            return (*o, *s, *folded)

        got, want, ref = gathered(), replaced(), plain()
        torch.cuda.synchronize()
        nbytes = gathered_axpy_bytes(n, rows, P, k, item)
        bound_ms, bound_by = roofline(
            nbytes, df_ops("df_axpy_norm", n, rows) + rank_sum_ops(P, k, False),
            word)
        res = {"kernel": "df_axpy_gathered", "dtype": word, "P": P, "k": k,
               "rows": rows, "n": n,
               "bitwise": bitwise(zip(got, want)) and bitwise(zip(got, ref)),
               "max_abs_err": max((a.double() - b.double()).abs().max().item()
                                  for a, b in zip(got, ref)),
               "ms": graph_ms(gathered), "replaced_ms": graph_ms(replaced),
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        res["share_of_bound"] = bound_ms / res["ms"]
        if dtype == torch.float32 and P <= 2:
            res["plain_ms"] = median_ms(plain, reps=3, warm=1)
        out.append(res)

        s2 = _gathered_record(torch, dtype, gen, P, 1, total=1.44)
        outs = [normalize_outputs(torch, w[0], m1) for _ in range(3)]

        def normalize(s2_, o):
            return normalize_call(df.df_normalize, (w, s1, (r2, w2, s2_, h1, c)),
                                  o, rows - 1)

        def normalize_replaced():
            sh, sl = df.df_rank_sum(s2.hi, s2.lo)
            return normalize((sh[0], sl[0]), outs[1])

        got = normalize(s2, outs[0])
        want = normalize_replaced()
        ref = normalize_call(df.df_normalize_plain,
                             (w, s1, (r2, w2, s2, h1, c)), outs[2], rows - 1)
        torch.cuda.synchronize()
        nbytes = normalize_bytes(n, m1, item) + (2 * P - 2) * item
        bound_ms, bound_by = roofline(
            nbytes, df_ops("df_normalize", n, m1=m1) + rank_sum_ops(P, 1, False),
            word)
        res = {"kernel": "df_normalize_gathered", "dtype": word, "P": P,
               "n": n, "bitwise": bitwise(zip(got, want))
               and bitwise(zip(got, ref)), "flag": float(got[4][rows - 1]),
               "max_abs_err": max((a.double() - b.double()).abs().max().item()
                                  for a, b in zip(got, ref)),
               "ms": graph_ms(lambda: normalize(s2, outs[0])),
               "replaced_ms": graph_ms(normalize_replaced),
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        res["share_of_bound"] = bound_ms / res["ms"]
        if dtype == torch.float32 and P <= 2:
            res["plain_ms"] = median_ms(lambda: normalize_call(
                df.df_normalize_plain, (w, s1, (r2, w2, s2, h1, c)), outs[2],
                rows - 1), reps=3, warm=1)
        out.append(res)
    return out


def _prologue_costs(torch, gen):
    """What folding a record in its consumer's prologue costs a launch, in
    float32 words at config 3's shapes: df_axpy's gathered form against
    its fused form on the folded coefficients, and df_normalize with a
    gathered s2 against the summed s2, at PROLOGUE_RANKS, each pair timed
    in the order fused, gathered, gathered, fused (graphs of 20 calls); the
    difference in microseconds."""
    from arnoldimethod_torch.ops import df

    dtype, lo = torch.float32, 2.0 ** -26
    n, m1, rows = 1 << 16, 61, 60

    def pair(*shape):
        h = torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)
        return h, torch.randn(*shape, dtype=dtype, device="cuda",
                              generator=gen) * lo

    V, w, w2, h1, c = pair(m1, n), pair(n), pair(n), pair(m1), pair(m1)
    r2, s1 = (tuple(torch.tensor(v * f, dtype=dtype, device="cuda")
                    for f in (1.0, lo)) for v in (9.0, 2.25))
    outs = normalize_outputs(torch, w[0], m1)
    out = []
    for P in PROLOGUE_RANKS:
        g = _gathered_record(torch, dtype, gen, P, m1 + 1)
        sh, sl = df.df_rank_sum(g.hi, g.lo)
        s2 = _gathered_record(torch, dtype, gen, P, 1, total=1.44)
        s2h, s2l = df.df_rank_sum(s2.hi, s2.lo)
        ways = {
            "df_axpy": (
                lambda: df.df_axpy(*w, sh[1:], sl[1:], *V, rows, True),
                lambda: df.df_axpy_gathered(*w, g, *V, rows, True)),
            "df_normalize": (
                lambda: normalize_call(df.df_normalize, (w, s1, (
                    r2, w2, (s2h[0], s2l[0]), h1, c)), outs, rows - 1),
                lambda: normalize_call(df.df_normalize, (w, s1, (
                    r2, w2, s2, h1, c)), outs, rows - 1)),
        }
        for name, (summed, gathered) in ways.items():
            a1, b1, b2, a2 = (graph_ms(f) for f in (summed, gathered, gathered,
                                                    summed))
            out.append({"kernel": name, "P": P, "summed_ms": [a1, a2],
                        "gathered_ms": [b1, b2],
                        "prologue_us": 1e3 * ((b1 + b2) - (a1 + a2)) / 2})
    return out


def _ptxas_functions(log):
    """Registers, stack frame and spills of each function in nvcc's
    -Xptxas -v output, by mangled name."""
    import re

    out, entry, current = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current:
            out.setdefault(current, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def _dense_ptxas(log):
    """Registers, stack frame and spills of csrc/dense_restart.cu's restart
    and finish kernels in both words and both storages."""
    import re

    rows = []
    for name, info in _ptxas_functions(log).items():
        m = re.search(r"(restart|finish)_kernelI([fd])Lb([01])E", name)
        if m:
            rows.append({"kernel": m.group(1),
                         "word": {"f": "float32", "d": "float64"}[m.group(2)],
                         "storage": "shared" if m.group(3) == "1" else "global",
                         **info})
    return sorted(rows, key=lambda r: (r["kernel"], r["word"], r["storage"]))


def _df_ptxas(log):
    """Registers, stack frame and spills of each instantiation of csrc/df.cu
    (project_kernel<word, L>, axpy_kernel<word, L, U, norm, gather>,
    normalize_kernel<word>, basis_kernel<word, R, C>, stencil_kernel<word, P>,
    rank_sum_kernel<word>) from nvcc's -Xptxas -v output."""
    import re

    rows = []
    for name, info in _ptxas_functions(log).items():
        m = re.search(r"(project|axpy|normalize|basis|stencil|rank_sum)"
                      r"_kernelI([fd])"
                      r"((?:L[ib]\d+E)*)E", name)
        if m:
            rows.append({"kernel": m.group(1),
                         "word": {"f": "float32", "d": "float64"}[m.group(2)],
                         "params": [int(v) for v in
                                    re.findall(r"L[ib](\d+)E", m.group(3))],
                         **info})
    return sorted(rows, key=lambda r: (r["kernel"], r["word"], r["params"]))


def _project_forms(torch, dtype, gen):
    """df_project against its plain version, bitwise with acc, in the full
    form at rows 1, 7 and 60 of a 61 x 65,536 basis and in the one-row
    form at n = 1, 1,000, 65,536 and 1,048,576; each with its launch plan,
    ms (CUDA graph of 20 calls), GB/s, bound and, where run F measured
    the case, the two-pass kernel's ms."""
    from arnoldimethod_torch.ops import df

    word = str(dtype).split(".")[-1]
    item = torch.finfo(dtype).bits // 8
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)

    def pair(*shape):
        h = torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)
        return h, torch.randn(*shape, dtype=dtype, device="cuda",
                              generator=gen) * lo

    cases = [(61, 65536, r) for r in (1, 7, 60)]
    cases += [(1, n, 1) for n in (1, 1000, 65536, 1 << 20)]
    earlier = {(1, 65536, 1): ("df_project_norm", "config3"),
               (1, 1 << 20, 1): ("df_project_norm", "1m"),
               (61, 65536, 60): ("df_project", "config3")}
    out = []
    for m1, n, rows in cases:
        wh, wl = pair(n)
        if m1 == 1:
            Vh, Vl = wh[None], wl[None]
            nbytes = 2 * n * item
        else:
            Vh, Vl = pair(m1, n)
            nbytes = (rows + 1) * n * 2 * item + 4 * m1 * item
        ah, al = pair(m1)
        acc_k, acc_p = (ah.clone(), al.clone()), (ah.clone(), al.clone())
        got = df.df_project(Vh, Vl, wh, wl, rows, acc_k)
        want = df.df_project_plain(Vh, Vl, wh, wl, rows, acc_p)
        torch.cuda.synchronize()
        same = bitwise(zip(got, want)) and bitwise(zip(acc_k, acc_p))
        ms = graph_ms(lambda: df.df_project(Vh, Vl, wh, wl, rows))
        bound_ms, bound_by = roofline(
            nbytes, df_ops("df_project_norm" if m1 == 1 else "df_project", n,
                           rows), word)
        key = earlier.get((m1, n, rows))
        was = TWO_PASS_PROJECT_MS.get((*key, word)) if key else None
        out.append({"m1": m1, "n": n, "rows": rows,
                    "plan": df.project_plan(n, rows, item)._asdict(),
                    "bitwise": same, "ms": ms, "gbs": nbytes / ms / 1e6,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "share_of_bound": bound_ms / ms,
                    "two_pass_ms": was if was is not None else "not measured",
                    "slower_than_two_pass": was is not None and ms > was})
    return out


def project_sweep(torch):
    """`--project-sweep`: df_project under other launch plans than
    project_plan's, one JSON line a case: every plan with 128 or 256
    threads, runs of 32 or 128 bytes and folds L = 0-4 (bitwise against the
    plain version), the default plan's ms and every plan's, fastest first."""
    from arnoldimethod_torch.ops import df

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, 65536, 1, torch.float32), (1, 1 << 20, 1, torch.float32),
             (61, 65536, 60, torch.float32), (61, 65536, 7, torch.float32),
             (61, 1 << 20, 60, torch.float32), (1, 65536, 1, torch.float64),
             (61, 1 << 20, 60, torch.float64)]
    for m1, n, rows, dtype in cases:
        item = torch.finfo(dtype).bits // 8
        lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
        wh = torch.randn(n, dtype=dtype, device="cuda", generator=gen)
        wl = torch.randn(n, dtype=dtype, device="cuda", generator=gen) * lo
        if m1 == 1:
            Vh, Vl = wh[None], wl[None]
        else:
            Vh = torch.randn(m1, n, dtype=dtype, device="cuda", generator=gen)
            Vl = torch.randn(m1, n, dtype=dtype, device="cuda",
                             generator=gen) * lo
        want = df.df_project_plain(Vh, Vl, wh, wl, rows)
        cap = df._PROJECT_STAGE_BYTES // (2 * item)
        timed, same = [], True
        for T in (128, 256):
            for run in (32, 128):
                for L in range(5):
                    G = n // (T << L)
                    if G < 1:
                        continue
                    C = run // item
                    p = df.ProjectPlan(
                        "one_row" if rows <= 1 else "full", T, C, G, L,
                        min(1 << (cap.bit_length() - 1), G * C))
                    got = df.KERNEL._project_launch(p, Vh, Vl, wh, wl, rows)
                    torch.cuda.synchronize()
                    same = same and bitwise(zip(got, want))
                    ms = graph_ms(lambda: df.KERNEL._project_launch(
                        p, Vh, Vl, wh, wl, rows))
                    timed.append((ms, p._asdict()))
        timed.sort(key=lambda t: t[0])
        default = df.project_plan(n, rows, item)
        emit({"phase": "project_sweep", "m1": m1, "n": n, "rows": rows,
              "dtype": str(dtype).split(".")[-1], "bitwise": same,
              "default": default._asdict(),
              "default_ms": graph_ms(lambda: df.df_project(Vh, Vl, wh, wl,
                                                           rows)),
              "plans": [{"ms": ms, **p} for ms, p in timed]})
        if not same:
            sys.exit("chip_smoke: a swept df_project plan is not bitwise")


def _clock_under_load(torch, fn, seconds=1.5):
    """nvidia-smi's SM clock and power, sampled every 200 ms while `fn`
    runs in a loop for `seconds`: the clock the operations bound assumes
    (clocks.max.sm) against the one the card holds."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    return out.strip().splitlines()[-3:]


def df_sweep(torch):
    """`--df-sweep`: df_basis_change under every tile of its word
    (df._BASIS_TILES) at 61 x 65,536 (rows 61, 46 and 31) and 61 x
    1,048,576, and stencil5_df with P = 1, 2 and 4 points a thread at 64^2,
    256^2, 1024^2 and 1021 x 1000, in both words: one JSON line a case,
    every plan bitwise against the plain version, the default plan and
    every plan's ms (CUDA graph of 20 calls), fastest first; with all rows,
    nvidia-smi's SM clock and power while the default plan runs."""
    from arnoldimethod_torch.ops import df

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        word = str(dtype).split(".")[-1]
        item = torch.finfo(dtype).bits // 8
        lo = 2.0 ** (-26 if dtype == torch.float32 else -55)

        def pair(*shape):
            h = torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)
            return h, torch.randn(*shape, dtype=dtype, device="cuda",
                                  generator=gen) * lo

        for m1, n, rows in ((61, 65536, 61), (61, 65536, 46), (61, 65536, 31),
                            (61, 1 << 20, 61)):
            Vh, Vl = pair(m1, n)
            Qh, Ql = pair(m1, m1)
            want = df.df_basis_change_plain(Vh, Vl, Qh, Ql, rows)
            dst = (torch.empty_like(want[0]), torch.empty_like(want[1]))
            timed, same = [], True
            for tile in df._BASIS_TILES[item]:
                plan = df.basis_plan(m1, n, rows, item, tile)
                got = df.KERNEL._basis_launch(plan, Vh, Vl, Qh, Ql, rows, dst)
                torch.cuda.synchronize()
                same = same and bitwise(zip(got, want))
                ms = graph_ms(lambda: df.KERNEL._basis_launch(
                    plan, Vh, Vl, Qh, Ql, rows, dst))
                timed.append((ms, plan._asdict()))
            timed.sort(key=lambda t: t[0])
            default = df.basis_plan(m1, n, rows, item)
            clock = _clock_under_load(torch, lambda: df.KERNEL._basis_launch(
                default, Vh, Vl, Qh, Ql, rows, dst)) if rows == m1 else None
            emit({"phase": "df_sweep", "kernel": "df_basis_change", "m1": m1,
                  "n": n, "rows": rows, "dtype": word, "bitwise": same,
                  "default": default._asdict(),
                  "plans": [{"ms": ms, **p} for ms, p in timed],
                  "sm_clock_power_under_load": clock})
            del Vh, Vl, want, dst
            if not same:
                sys.exit("chip_smoke: a swept df_basis_change plan is not bitwise")
        coeffs = (4.0, -1.0 - 0.5039, -1.0 + 0.5039, -1.0, -1.0)
        for grid in ((64, 64), (256, 256), (1024, 1024), (1021, 1000)):
            xh, xl = pair(grid[0] * grid[1])
            want = df.stencil5_df_plain(xh, xl, coeffs, grid)
            timed, same = [], True
            for P in (1, 2, 4):
                got = df.KERNEL._stencil_launch(P, xh, xl, coeffs, grid)
                torch.cuda.synchronize()
                same = same and bitwise(zip(got, want))
                ms = graph_ms(lambda: df.KERNEL._stencil_launch(
                    P, xh, xl, coeffs, grid))
                timed.append((ms, P))
            timed.sort()
            emit({"phase": "df_sweep", "kernel": "stencil5_df",
                  "grid": list(grid), "dtype": word, "bitwise": same,
                  "default": df.stencil_plan(*grid, item)._asdict(),
                  "plans": [{"ms": ms, "P": P} for ms, P in timed]})
            if not same:
                sys.exit("chip_smoke: a swept stencil5_df plan is not bitwise")


def _replay(torch, call):
    """20 eager calls of `call` (a double-word kernel that keeps
    df_project's scratch), then 20 calls captured in one CUDA graph and
    replayed 10 times, twice: captured on a stream that called it before
    (the stream's scratch, whose arrival counters each launch resets) and
    on torch.cuda.graph's own stream, which never called it (scratch of
    each call's own, zeroed inside the graph).  Every output equals the
    first eager call's bit for bit."""
    from arnoldimethod_torch.ops import df

    want = call()
    eager = [call() for _ in range(20)]
    torch.cuda.synchronize()
    ok = {"eager": all(bitwise(zip(o, want)) for o in eager)}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    like = want[0]
    for name, stream in (("warm_stream", side), ("fresh_stream", None)):
        graph, outs = torch.cuda.CUDAGraph(), []
        with torch.cuda.graph(graph, stream=stream):
            key = (like.device, like.dtype, torch.cuda.current_stream().cuda_stream)
            ok[name + "_cached"] = key in df.KERNEL._scratch
            for _ in range(20):
                outs.append(call())
        same = True
        for _ in range(10):
            graph.replay()
            torch.cuda.synchronize()
            same = same and all(bitwise(zip(o, want)) for o in outs)
        ok[name] = same
    return {"calls": 20, "replays": 10, **ok,
            "bitwise": ok["eager"] and ok["warm_stream"]
            and ok["fresh_stream"] and ok["warm_stream_cached"]
            and not ok["fresh_stream_cached"]}


def _project_replay(torch, gen, n, m1, rows):
    """df_project under `_replay`."""
    from arnoldimethod_torch.ops import df

    Vh = torch.randn(m1, n, device="cuda", generator=gen)
    Vl = torch.randn(m1, n, device="cuda", generator=gen) * 2.0 ** -26
    wh, wl = Vh[0].clone(), Vl[0].clone() * 0.5
    if m1 == 1:
        wh, wl = Vh[0], Vl[0]
    return {"n": n, "m1": m1, "rows": rows,
            **_replay(torch, lambda: df.df_project(Vh, Vl, wh, wl, rows))}


def _axpy_replay(torch, gen, n, rows, dtype):
    """df_axpy's fused form under `_replay` (its scratch is df_project's)."""
    from arnoldimethod_torch.ops import df

    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
    Vh = torch.randn(61, n, dtype=dtype, device="cuda", generator=gen)
    Vl = torch.randn(61, n, dtype=dtype, device="cuda", generator=gen) * lo
    wh, wl = Vh[60].clone() * 0.5, Vl[60].clone()
    hh, hl = Vh[:, 0].clone(), Vl[:, 0].clone()
    return {"kernel": "df_axpy_norm", "n": n, "rows": rows,
            "dtype": str(dtype).split(".")[-1],
            **_replay(torch, lambda: _flat(df.df_axpy(
                wh, wl, hh, hl, Vh, Vl, rows, norm=True)))}


def _axpy_rows(torch, dtype, gen):
    """df_axpy in both forms over rows 31 and 46 of a 61 x 65,536 basis
    (the range of config 3's passes), against the plain version, bitwise:
    plan, ms (a graph of 20 calls), bound and plain ms.  The earlier kernel was
    not timed at these rows."""
    from arnoldimethod_torch.ops import df

    word = str(dtype).split(".")[-1]
    item = torch.finfo(dtype).bits // 8
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)

    def pair(*shape):
        h = torch.randn(*shape, dtype=dtype, device="cuda", generator=gen)
        return h, torch.randn(*shape, dtype=dtype, device="cuda",
                              generator=gen) * lo

    m1, n = 61, 65536
    Vh, Vl = pair(m1, n)
    wh, wl = pair(n)
    hh, hl = pair(m1)
    out = []
    for rows in (31, 46):
        for norm in (False, True):
            def kernel():
                got = df.df_axpy(wh, wl, hh, hl, Vh, Vl, rows, norm)
                return _flat(got) if norm else got

            def plain():
                got = df.df_axpy_plain(wh, wl, hh, hl, Vh, Vl, rows, norm)
                return _flat(got) if norm else got

            same = bitwise(zip(kernel(), plain()))
            ms = graph_ms(kernel)
            name = "df_axpy_norm" if norm else "df_axpy"
            nbytes = (axpy_norm_bytes(n, rows, item) if norm
                      else (rows + 2) * n * 2 * item)
            bound_ms, bound_by = roofline(nbytes, df_ops(name, n, rows), word)
            out.append({"kernel": name, "m1": m1, "n": n, "rows": rows,
                        "plan": df.axpy_plan(n, rows, item, norm)._asdict(),
                        "bitwise": same, "ms": ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                        "plain_ms": median_ms(plain, reps=3, warm=1),
                        "earlier_ms": "not measured"})
    return out


def axpy_sweep(torch):
    """`--axpy-sweep`: df_axpy, plain and fused, under launch plans other
    than axpy_plan's at 61 x 65,536 and 61 x 1,048,576 (60 rows), both
    words: T = 128 or 256 threads, every instantiated (L, U) (2^L elements
    a thread, U rows loaded a group), runs of 32 or 128 bytes or (plain
    form) of the whole block; every plan bitwise against the plain version
    and timed (a graph of 20 calls), one JSON line a case, fastest first,
    beside the default plan's ms."""
    from arnoldimethod_torch.ops import df

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        word = str(dtype).split(".")[-1]
        item = torch.finfo(dtype).bits // 8
        lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
        for n in (65536, 1 << 20):
            rows = 60
            Vh = torch.randn(61, n, dtype=dtype, device="cuda", generator=gen)
            Vl = torch.randn(61, n, dtype=dtype, device="cuda",
                             generator=gen) * lo
            wh, wl = Vh[60].clone() * 0.5, Vl[60].clone()
            hh, hl = Vh[:, 0].clone(), Vl[:, 0].clone()
            N = 1 << (n - 1).bit_length()
            for norm in (False, True):
                want = df.df_axpy_plain(wh, wl, hh, hl, Vh, Vl, rows, norm)
                want = _flat(want) if norm else want
                default = df.axpy_plan(n, rows, item, norm)
                plans = []
                for T in (128, 256):
                    for L, U in df._AXPY_SHAPES:
                        G = N // (T << L)
                        runs = {32 // item, 128 // item} | ({T} if not norm else set())
                        for C in sorted(runs):
                            plans.append(df.AxpyPlan(
                                T, C, G, L, U, min(df._AXPY_SUM_PAIRS, G * C)))
                timed, same = [], True

                def call(p):
                    got = df.KERNEL._axpy_launch(p, wh, wl, hh, hl, Vh, Vl,
                                                 rows, norm)
                    return _flat(got) if norm else got

                for p in plans:
                    got = call(p)
                    torch.cuda.synchronize()
                    ok = bitwise(zip(got, want))
                    same = same and ok
                    timed.append((graph_ms(lambda: call(p)), ok, p._asdict()))
                timed.sort(key=lambda t: t[0])
                emit({"phase": "axpy_sweep", "n": n, "rows": rows,
                      "dtype": word, "norm": norm, "bitwise": same,
                      "default": default._asdict(),
                      "default_ms": graph_ms(lambda: call(default)),
                      "plans": [{"ms": ms, "bitwise": ok, **p}
                                for ms, ok, p in timed]})
                if not same:
                    sys.exit("chip_smoke: a swept df_axpy plan is not bitwise")
            del Vh, Vl


def phase_df_kernel(torch):
    """The five double-word kernels (with df_project on one row, the form
    the r2 of every step takes, and df_axpy's fused norm, the form every
    other norm takes) against their plain versions, bitwise, in float32
    and float64 words, at config 3's shapes (61 x 65,536 on the 256^2
    grid), 61 x 1,048,576 (1024^2) and a non-power-of-two n (1021 x 1000);
    kernel ms from a CUDA graph of 20 calls, plain ms (config 3 only) from
    CUDA events.  First, two_prod's exactness for both words.  Then
    df_project alone: both forms at more shapes (`_project_forms`), 20
    calls in a CUDA graph replayed 10 times against one eager call; df_axpy
    in both forms at rows 31 and 46 (`_axpy_rows`) and its fused form under
    graph replays (`_axpy_replay`).  df_normalize at 65,536 and 1,048,576
    rows, aligned and one word off, in every decision case
    (`_normalize_forms`).  Then df_basis_change at rows 31, 46 and 61, new
    and in place, and stencil5_df at 64^2 (`_df_windows`), and df_rank_sum
    at RANK_SUM_SHAPES (`phase_rank_sum`).
    Last, ptxas' registers, stack and spills for each of the file's 115
    instantiations (none may use local memory).  Each timed case of a
    redesigned kernel names the earlier kernel's time
    (`slower_than_earlier`) and, where set, its target (`meets_target`)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.float64):
        bad = _two_prod_exact(torch, dtype, gen)
        check("df_kernel", bad == 0, case="two_prod_exact",
              dtype=str(dtype).split(".")[-1], inexact=bad)
    for dtype in (torch.float32, torch.float64):
        for case, grid in (("config3", (256, 256)), ("1m", (1024, 1024)),
                           ("odd", (1021, 1000))):
            res = _df_case(torch, grid, dtype, gen, case == "config3")
            word = str(dtype).split(".")[-1]
            results[(case, word)] = res
            check("df_kernel", all(r["bitwise"] for r in res.values()),
                  case=case, dtype=word, grid=list(grid), m1=61, rows=60,
                  kernels=res)
    # df_project: both forms at more shapes, graph replays, and ptxas'
    # report of every instantiation (no local memory, no spills).
    for dtype in (torch.float32, torch.float64):
        forms = _project_forms(torch, dtype, gen)
        check("df_kernel", all(f["bitwise"] for f in forms),
              case="df_project_forms", dtype=str(dtype).split(".")[-1],
              forms=forms)
        results[("forms", str(dtype).split(".")[-1])] = forms
    replays = [_project_replay(torch, gen, *shape)
               for shape in ((65536, 61, 60), (65536, 1, 1),
                             (1 << 20, 61, 60), (1000, 61, 7))]
    check("df_kernel", all(r["bitwise"] for r in replays),
          case="df_project_graph_replay", replays=replays)
    # df_axpy in both forms at config 3's other rows, and its fused form
    # under graph replays, both words.
    for dtype in (torch.float32, torch.float64):
        rows = _axpy_rows(torch, dtype, gen)
        check("df_kernel", all(r["bitwise"] for r in rows),
              case="df_axpy_rows", dtype=str(dtype).split(".")[-1], rows=rows)
    replays = [_axpy_replay(torch, gen, n, rows, dtype)
               for dtype in (torch.float32, torch.float64)
               for n, rows in ((65536, 60), (65536, 31), (1 << 20, 60),
                               (1021 * 1000, 46))]
    check("df_kernel", all(r["bitwise"] for r in replays),
          case="df_axpy_graph_replay", replays=replays)
    # df_normalize: both sizes, aligned and not, every decision.
    broke = ("second_breakdown", "zero")
    for dtype in (torch.float32, torch.float64):
        forms = _normalize_forms(torch, dtype, gen)
        check("df_kernel", all(
                  f["bitwise"] and f["finite"]
                  and f["flag"] == (1.0 if f["case"] in broke else 0.0)
                  for f in forms),
              case="df_normalize_forms", dtype=str(dtype).split(".")[-1],
              forms=forms)
    from arnoldimethod_torch.ops import df

    # Windows of df_basis_change's rows, in place, and stencil5_df's floor.
    for dtype in (torch.float32, torch.float64):
        windows = _df_windows(torch, dtype, gen)
        check("df_kernel", all(w["bitwise"] for w in windows),
              case="df_windows", dtype=str(dtype).split(".")[-1],
              windows=windows)
        results[("windows", str(dtype).split(".")[-1])] = windows
    rank_sums = phase_rank_sum(torch, gen)
    # ptxas: 10 df_project, 88 df_axpy (11 shapes (L, U), plain or fused,
    # in its own form or gathered), 2 df_normalize, 5 df_basis_change, 6
    # stencil5_df and 2 df_rank_sum instantiations, none with local memory.
    ptxas = _df_ptxas(df.KERNEL.build_log)
    built = bool(df.KERNEL.build_log)
    want = {"project": 10, "axpy": 88, "normalize": 2, "basis": 5,
            "stencil": 6, "rank_sum": 2}
    counts = {k: sum(p["kernel"] == k for p in ptxas) for k in want}
    check("df_kernel", not built or (
              counts == want
              and all(p.get("stack") == 0 and p.get("spill_stores") == 0
                      and p.get("spill_loads") == 0 for p in ptxas)),
          case="df_ptxas", built_here=built, counts=counts,
          instantiations=ptxas)
    shape = dict(results[("config3", "float32")])
    norm = shape["df_project_norm"]
    shape["df_project"] = dict(
        shape["df_project"], one_row_ms=norm["ms"],
        one_row_bound_ms=norm["bound_ms"])
    shape.update(rank_sums)
    return shape


def phase_rank_sum(torch, gen):
    """df_rank_sum (the sharded extended solve's sum over the ranks)
    against its plain version at RANK_SUM_SHAPES in both words, with and
    without acc, bitwise.  Returns the kernels-line numbers: the P = 2,
    k = 62 float32 case's (sharded_ext_p2's shape), with the P = 1 case's
    beside them (sharded_ext_p1's)."""
    cases = [c for dtype in (torch.float32, torch.float64)
             for c in _rank_sum_cases(torch, dtype, gen)]
    check("df_kernel", all(c["bitwise"] for c in cases), case="df_rank_sum",
          cases=cases)
    gathered = [c for dtype in (torch.float32, torch.float64)
                for c in _gathered_cases(torch, dtype, gen)]
    check("df_kernel", all(c["bitwise"] for c in gathered)
          and all(c["flag"] == 0.0 for c in gathered
                  if c["kernel"] == "df_normalize_gathered"),
          case="gathered_forms", cases=gathered)
    prologue = _prologue_costs(torch, gen)
    check("df_kernel", True, case="gathered_prologue", dtype="float32",
          n=1 << 16, rows=60, costs=prologue)

    def at(P, k):
        return next(c for c in cases if (c["P"], c["k"], c["acc"],
                                         c["dtype"]) == (P, k, False,
                                                         "float32"))

    def line(main, one, errs):
        return dict(
            {key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            max_abs_err=max(c["max_abs_err"] for c in errs),
            case=f"P = 2, k = {main['k']}, float32", one_rank_ms=one["ms"],
            one_rank_bound_ms=one["bound_ms"],
            one_rank_plain_ms=one["plain_ms"])

    def gathered_at(kernel, P):
        return next(c for c in gathered if (c["kernel"], c["P"], c["dtype"])
                    == (kernel, P, "float32"))

    out = {"df_rank_sum": line(at(2, 62), at(1, 62), cases)}
    for kernel in ("df_axpy_gathered", "df_normalize_gathered"):
        main = gathered_at(kernel, 2)
        out[kernel] = dict(
            line(dict(main, k=main.get("k", 1)), gathered_at(kernel, 1),
                 [c for c in gathered if c["kernel"] == kernel]),
            replaced_ms=main["replaced_ms"],
            one_rank_replaced_ms=gathered_at(kernel, 1)["replaced_ms"])
    return out


def phase_default_device(torch):
    """No device named: the README config solves on the card."""
    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.problems import laplacian_1d

    op = laplacian_1d(100)
    d, h = partial_schur(op, nev=10, which="SR")
    check("default_device", op.device.type == "cuda"
          and d.Q_rows.device.type == "cuda" and h.converged,
          operator_device=str(op.device), basis_device=str(d.Q_rows.device),
          mvproducts=h.mvproducts)


def phase_complex_bsr(torch):
    """A complex clustered scipy matrix through partial_schur(S,
    device="cuda"): the format rule picks BSR, the real kernel runs on the
    two words (four launches a matvec), and the complex64 solve agrees with
    the same solve in complex128 on the CPU."""
    import numpy as np
    import scipy.sparse as sp

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.operators import pick_sparse_format
    from arnoldimethod_torch.ops import bsr

    nbr, KB, B = 32, 8, 128
    n = nbr * B
    cols, re = bsr_pattern(nbr, KB, B, np.float32)
    im = np.random.default_rng(8).standard_normal(re.shape, dtype=np.float32)
    im *= np.float32(0.01)
    for g in range(10):  # the ten outliers move off the real axis
        r = g // B
        k = int(np.searchsorted(cols[r], r))
        im[r, k, g % B, g % B] += 0.05 * g
    data = (re + 1j * im).astype(np.complex64)
    S = sp.bsr_matrix((data.reshape(-1, B, B), cols.ravel(),
                       np.arange(0, nbr * KB + 1, KB)), shape=(n, n)).tocsr()
    fmt, _ = pick_sparse_format(S.indptr, S.indices, S.shape)
    v1 = np.random.default_rng(1).standard_normal(n)
    kw = dict(v1=v1, nev=6, which="LM")
    bsr.KERNEL.launches = 0
    t0 = time.perf_counter()
    d, h = partial_schur(S, device="cuda", tol=1e-6, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsr.KERNEL.launches
    dc, hc = partial_schur(S.astype(np.complex128), device="cpu", tol=1e-10,
                           **kw)
    lam = d.eigenvalues
    err = (max(float(np.abs(dc.eigenvalues - z).min()) for z in lam)
           if len(lam) else math.inf)
    check("complex_bsr", fmt == "bsr" and h.converged and hc.converged
          and d.Q.dtype == torch.complex64 and launches == 4 * h.mvproducts
          and err <= 1e-5,
          n=n, nnz=S.nnz, format=fmt, mvproducts=h.mvproducts,
          kernel_launches=launches, wall_s=wall,
          cpu_c128_mvproducts=hc.mvproducts, lam_err_vs_c128=err,
          eigenvalues=[[z.real, z.imag] for z in lam])


def _warm_walls(torch, fn, runs=3):
    """`runs` timed calls of fn after the first; returns (last result,
    walls)."""
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def phase_complexsc(torch):
    """bench.py's complex_sc in the port (split_complex=True on a complex64
    dense matrix, :LI), checked in complex128 on the host."""
    import numpy as np

    from arnoldimethod_torch import partial_schur

    rng = np.random.default_rng(0)
    n = 1500
    A = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
         / np.sqrt(n)).astype(np.complex64)
    Adev = torch.from_numpy(A).to("cuda")
    kw = dict(nev=8, which="LI", tol=1e-5, mindim=16, maxdim=32,
              restarts=500, split_complex=True)
    (_, h0), cold = _warm_walls(torch, lambda: partial_schur(Adev, **kw), 1)
    (d, h), walls = _warm_walls(torch, lambda: partial_schur(Adev, **kw))
    A64 = A.astype(np.complex128)
    Q = d.Q.cpu().numpy().astype(np.complex128)
    k = Q.shape[1]
    resid = float(np.linalg.norm(A64 @ Q - Q @ d.R) / np.linalg.norm(A64))
    orth = float(np.linalg.norm(Q.conj().T @ Q - np.eye(k)))
    lam_ref = np.linalg.eigvals(A64)
    lam_ref = np.sort(lam_ref[np.argsort(-lam_ref.imag)][:8].imag)
    lam_got = np.sort(d.eigenvalues.imag)
    err = (float(np.abs(lam_got - lam_ref).max()) if len(lam_got) == 8
           else math.inf)
    check("complexsc", h0.converged and h.converged and k == 8
          and d.Q.dtype == torch.complex64 and resid <= 1e-5
          and orth <= 1e-5 and err <= 1e-4,
          n=n, mvproducts=h.mvproducts, restarts=h.restarts,
          wall_cold_s=cold[0], wall_warm_s_median=statistics.median(walls),
          walls_warm_s=walls, host_syncs=h.host_syncs,
          schur_resid_rel=resid, orth=orth, li_eig_err=err,
          jax_tpu_record={"schur_resid": 7.3e-8, "wall_warm_s": 5.0,
                          "source": "README.md:326, a TPU record"})


def phase_complexscsparse(torch):
    """bench.py's complex_sc_sparse in the port: the split DIA pair with
    split_complex=True, and the native complex DiaOperator of the same
    matrix beside it."""
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.operators import (
        DiaOperator,
        SplitComplexOperator,
        dia_from_diagonals,
    )

    n = 1 << 20
    rng = np.random.default_rng(42)
    z = rng.uniform(-1.0, 1.0, n) + 1j * rng.uniform(0.0, 1.0, n)
    planted = np.linspace(2.0, 2.9, 10)
    idx = rng.choice(n, size=10, replace=False)
    z[idx] = 0.3 * rng.standard_normal(10) + 1j * planted
    beta = 0.01
    native = dia_from_diagonals(
        {0: z.astype(np.complex64), 1: beta, -1: 1j * beta}, (n, n),
        dtype=np.complex64, device="cuda")
    split = SplitComplexOperator(
        DiaOperator(native.diags.real.contiguous(), native.offsets, (n, n)),
        DiaOperator(native.diags.imag.contiguous(), native.offsets, (n, n)))
    kw = dict(nev=8, which="LI", tol=1e-5, mindim=16, maxdim=32,
              restarts=500)

    def check_host(d):
        Q = d.Q.cpu().numpy().astype(np.complex128)
        AQ = z[:, None] * Q
        AQ[:-1] += beta * Q[1:]
        AQ[1:] += 1j * beta * Q[:-1]
        resid = float(np.linalg.norm(AQ - Q @ d.R))
        orth = float(np.linalg.norm(Q.conj().T @ Q - np.eye(Q.shape[1])))
        imag = np.sort(d.eigenvalues.imag)[-8:]
        err = (float(np.abs(imag - planted[-8:]).max()) if len(imag) == 8
               else math.inf)
        return resid, orth, err

    out = {}
    for name, op, extra in (("split", split, {"split_complex": True}),
                            ("native", native, {})):
        (_, h0), cold = _warm_walls(
            torch, lambda: partial_schur(op, **kw, **extra), 1)
        (d, h), walls = _warm_walls(
            torch, lambda: partial_schur(op, **kw, **extra))
        resid, orth, err = check_host(d)
        out[name] = dict(
            converged=h0.converged and h.converged, mvproducts=h.mvproducts,
            restarts=h.restarts, wall_cold_s=cold[0],
            wall_warm_s_median=statistics.median(walls), walls_warm_s=walls,
            schur_resid_f64=resid, orth_f64=orth, li_eig_err=err,
            li_eig_ok=err < 0.021,
            finite=bool(math.isfinite(resid) and math.isfinite(orth)),
            basis_dtype=str(d.Q.dtype))
    check("complexscsparse", all(
        r["converged"] and r["li_eig_ok"] and r["finite"]
        and r["basis_dtype"] == "torch.complex64" for r in out.values()),
        n=n, **out,
        jax_tpu_record={"mvproducts": 57, "wall_warm_s": 3.3,
                        "source": "README.md:327, a TPU record"})


def _lap1d_dense(n):
    import numpy as np

    return (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
            + np.diag(np.full(n - 1, -1.0), -1))


def _ext_solve(torch, n, dtype, device, tol, nev, v1):
    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.problems import laplacian_1d

    op = laplacian_1d(n, dtype=dtype, device=device)
    t0 = time.perf_counter()
    d, h = partial_schur(op, nev=nev, which="SR", tol=tol, extended=True,
                         v1=v1)
    if device == "cuda":
        torch.cuda.synchronize()
    return d, h, time.perf_counter() - t0


def phase_ext_readme(torch):
    """laplacian_1d(100) with float32 words, nev=10, :SR, tol=1e-12, from
    one v1, on the card and on the CPU: the Schur residual in host float64
    and the matvec counts."""
    import numpy as np

    v1 = np.random.default_rng(11).standard_normal(100)
    d, h, wall = _ext_solve(torch, 100, torch.float32, "cuda", 1e-12, 10, v1)
    _, hc, wall_cpu = _ext_solve(torch, 100, torch.float32, "cpu", 1e-12, 10,
                                 v1)
    Q = d.Q.cpu().numpy()
    resid = float(np.linalg.norm(_lap1d_dense(100) @ Q - Q @ d.R))
    orth = float(np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])))
    check("ext_readme", h.converged and resid < 1e-11
          and h.mvproducts == hc.mvproducts and Q.dtype == np.float64,
          mvproducts=h.mvproducts, mvproducts_cpu=hc.mvproducts,
          restarts=h.restarts, schur_residual=resid, orthonormality=orth,
          wall_s=wall, wall_cpu_s=wall_cpu, host_syncs=h.host_syncs,
          jax_tpu_record={"mvproducts": 251, "source": "README, JAX package"})


def _exact_dd_residual(d):
    """||A Q - Q R|| and max |Q^T Q - I| of a double-double result of the
    1-D Laplacian, in exact rational arithmetic over (Q + Q_lo, R + R_lo)."""
    from fractions import Fraction

    import numpy as np

    def frac(hi, lo):
        out = np.empty(hi.shape, dtype=object)
        for idx in np.ndindex(hi.shape):
            out[idx] = Fraction(float(hi[idx])) + Fraction(float(lo[idx]))
        return out

    Qf = frac(d.Q.cpu().numpy(), d.Q_lo.cpu().numpy())
    Rf = frac(np.asarray(d.R), np.asarray(d.R_lo))
    AQ = 2 * Qf
    AQ[:-1] -= Qf[1:]
    AQ[1:] -= Qf[:-1]
    resid = float(sum(v * v for v in (AQ - Qf @ Rf).ravel())) ** 0.5
    G = Qf.T @ Qf
    for i in range(G.shape[0]):
        G[i, i] -= 1
    return resid, max(abs(float(v)) for v in G.ravel())


def phase_ext_dd(torch):
    """float64 words (the host dense layer in double-double): the README
    matrix at tol=1e-28 on the card, exact-rational residual and
    orthonormality; laplacian_1d(40) at tol=1e-24 on card and CPU, same
    matvec count."""
    import numpy as np

    v1 = np.random.default_rng(11).standard_normal(100)
    d, h, wall = _ext_solve(torch, 100, torch.float64, "cuda", 1e-28, 10, v1)
    resid, orth = _exact_dd_residual(d)
    lam = np.sort(d.eigenvalues.real)
    exact = 2 - 2 * np.cos(np.pi * np.arange(1, 11) / 101)
    lam_err = float(np.max(np.abs(lam - exact))) if lam.size == 10 else math.inf
    v40 = np.random.default_rng(12).standard_normal(40)
    _, h40, _ = _ext_solve(torch, 40, torch.float64, "cuda", 1e-24, 4, v40)
    _, h40c, _ = _ext_solve(torch, 40, torch.float64, "cpu", 1e-24, 4, v40)
    check("ext_dd", h.converged and h.mvproducts <= 600 and resid < 1e-26
          and orth < 1e-28 and h40.converged
          and h40.mvproducts == h40c.mvproducts,
          mvproducts=h.mvproducts, restarts=h.restarts, exact_residual=resid,
          orthonormality=orth, lam_err=lam_err, wall_s=wall,
          timings=h.timings, n40_mvproducts=h40.mvproducts,
          n40_mvproducts_cpu=h40c.mvproducts,
          records={"jax_cpu_mvproducts": 451, "reference_mvproducts": 442,
                   "source": "ROADMAP.md item 11, README"})


def phase_ext_conv(torch):
    """Config 3 at full size (bench.py:862-919): the Dirichlet
    convection-diffusion stencil, nx = 256 (n = 65,536), peclet = 4 (nx+1),
    float32 words, nev=10, :LM, tol=1e-6, mindim=30, maxdim=60,
    restarts=1000, extended=True, from v1 = N(0, 1) of numpy seed 3.  The
    residual in host float64 as bench.py computes it; every double-word
    kernel launched, no plain double-word op on the card, df_mul_by gone,
    one host read a range and one a rollback.  Then the same solve with
    the stepwise range (host decisions each step) swapped in, and the
    range's solve once more: the same bits, and the three walls.

    The start matters here: the operator is far from normal (beta = 2) and
    locking waits on the Schur-coupling floor, so the restarts to converge
    spread widely with the start (on the H100, 4 of 14 random starts
    converged within 1000 restarts, at 213 to 609; PERF.md).  Seed 3 is one
    of the four; the solve is deterministic on the card."""
    import numpy as np

    from arnoldimethod_torch import driver, partial_schur
    from arnoldimethod_torch.ops import bsr, df, df32, stencil
    from arnoldimethod_torch.ops import df_expansion as tde
    from arnoldimethod_torch.ops.expansion import LOWSYNC

    nx = 256
    op, kw = _config3(torch)

    def solve():
        t0 = time.perf_counter()
        d, h = partial_schur(op, restarts=1000, extended=True, **kw)
        torch.cuda.synchronize()
        return d, h, time.perf_counter() - t0

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stencil.KERNEL.launches = bsr.KERNEL.launches = 0
    df.KERNEL.launches = dict.fromkeys(df.KERNEL.launches, 0)
    df.KERNEL.project_forms = dict.fromkeys(df.KERNEL.project_forms, 0)
    df.KERNEL.axpy_forms = dict.fromkeys(df.KERNEL.axpy_forms, 0)
    df32.PLAIN_ON_CARD = 0
    LOWSYNC.rollbacks = LOWSYNC.discarded_matvecs = 0
    d, h, wall = solve()
    launches = dict(df.KERNEL.launches)
    forms = dict(df.KERNEL.project_forms)
    axpy_forms = dict(df.KERNEL.axpy_forms)
    plain = df32.PLAIN_ON_CARD
    rollbacks = LOWSYNC.rollbacks
    peak = torch.cuda.max_memory_allocated()

    beta = 4.0 * (nx + 1) * (1.0 / (nx + 1)) / 2.0

    def residual(d):
        Q = d.Q.cpu().numpy()
        G = Q.reshape(nx, nx, -1)
        AQg = 4.0 * G.copy()
        AQg[:, 1:] += (-1.0 - beta) * G[:, :-1]
        AQg[:, :-1] += (-1.0 + beta) * G[:, 1:]
        AQg[1:, :] += -1.0 * G[:-1, :]
        AQg[:-1, :] += -1.0 * G[1:, :]
        return float(np.linalg.norm(AQg.reshape(nx * nx, -1) - Q @ d.R))

    resid = residual(d)
    pairs = int(np.sum(d.eigenvalues.imag > 0))
    # The solve is deterministic and every double-word kernel bitwise, so
    # it repeats the two-pass kernel's run F to every printed digit.
    repeats = (h.mvproducts == 6387 and h.restarts == 213
               and f"{resid:.3e}" == "3.872e-12")
    # One read a range (the first and one a restart) and one a rollback.
    ranges = h.restarts + 1
    reads_ok = h.host_syncs <= ranges + rollbacks + 3
    df_calls = sum(launches.values())
    # Every Gram-Schmidt pass that reads a norm takes it from its df_axpy
    # launch: the one-row df_project is left to the r2 of each step and the
    # start (18,188 one-row launches before the fusion, PERF.md §5).
    # Every double-word kernel but the sum over the ranks, which the
    # unsharded path never launches.
    unsharded = {k: v for k, v in launches.items() if k != "df_rank_sum"}
    check("ext_conv", h.converged and h.nconverged >= 10 and pairs >= 1
          and resid <= 1e-8 and all(v > 0 for v in unsharded.values())
          and launches["df_rank_sum"] == 0
          and plain == 0 and stencil.KERNEL.launches == 0 and repeats
          and axpy_forms["norm"] > 0 and forms["one_row"] < 7000
          and not hasattr(df, "df_mul_by") and "df_mul_by" not in launches
          and launches["df_normalize"] > 0 and reads_ok,
          n=nx * nx, mvproducts=h.mvproducts, restarts=h.restarts,
          nconverged=h.nconverged, complex_pairs=pairs, schur_residual=resid,
          repeats_two_pass=repeats,
          two_pass_record={"mvproducts": 6387, "restarts": 213,
                      "schur_residual": "3.872e-12", "wall_s": [3.779, 8.176],
                      "device_busy_share": [0.073, 0.122],
                      "df_project_share_of_device": 0.55,
                      "source": "PERF.md §5, runs F and H"},
          wall_s=wall, timings=h.timings, dense_layer=h.dense_layer,
          host_syncs=h.host_syncs, syncs_per_step=h.host_syncs / h.mvproducts,
          read_limit=ranges + rollbacks + 3, rollbacks=rollbacks,
          discarded_matvecs=LOWSYNC.discarded_matvecs,
          df_launches=launches, df_launches_per_step=df_calls / h.mvproducts,
          df_project_forms=forms, df_axpy_forms=axpy_forms,
          stepwise_record={"syncs_per_step": 1.847, "launches_per_step": "~13",
                           "source": "PERF.md §5, the stepwise range"},
          column_axpy_record={"df_axpy_with_df_mul_by": 18186,
                              "one_row_df_project": 18188,
                              "source": "PERF.md §5, before the fusion"},
          plain_df_calls_on_card=plain,
          stencil_launches=stencil.KERNEL.launches, peak_mem_bytes=peak,
          resident_before_bytes=resident,
          eigenvalues=[[z.real, z.imag] for z in d.eigenvalues],
          jax_tpu_record={"source": "benchmarks/results/bench_capture_r5.json "
                          "(JAX on a TPU)", "mvproducts": 25762,
                          "schur_residual": 4.228e-10, "complex_pairs": 5,
                          "wall_s": 107.65})
    # The stepwise range (host decisions, one or two reads a step) swapped
    # in for one solve, then the range's solve once more.
    def stepwise(op, Vh, Vl, Hh, Hl, j0, j1, generator, comm=None):
        reads = tde.df_expand_range_stepwise(op, Vh, Vl, Hh, Hl, j0, j1,
                                             generator, comm)
        return (Hh.cpu().numpy(), Hl.cpu().numpy()), reads

    real_range, walls = tde.df_expand_range, [wall]
    driver.df_expand_range = tde.df_expand_range = stepwise
    try:
        d_step, h_step, w_step = solve()
    finally:
        driver.df_expand_range = tde.df_expand_range = real_range
    walls.append(solve()[2])
    same = all(np.array_equal(a, b, equal_nan=True) for a, b in (
        (d.Q.cpu().numpy(), d_step.Q.cpu().numpy()), (d.R, d_step.R),
        (d.eigenvalues, d_step.eigenvalues)))
    check("ext_conv_stepwise", same and h_step.mvproducts == h.mvproducts
          and h_step.restarts == h.restarts,
          mvproducts=h_step.mvproducts, restarts=h_step.restarts,
          same_bits=same, walls_s=walls, stepwise_wall_s=w_step,
          stepwise_syncs_per_step=h_step.host_syncs / h_step.mvproducts,
          syncs_per_step=h.host_syncs / h.mvproducts,
          wall_over_stepwise=statistics.median(walls) / w_step)
    check("ext_conv_host", True, **_step_host_us(torch, op))
    # One device launch a df_project call, both forms, in the profiled
    # solve; at most 8 device launches a Krylov step, everything counted.
    # A profile that lost device records (PR 14 run E) is taken once more;
    # the count must hold exactly in one of them.
    seen = []
    for _ in range(2):
        calls = df.KERNEL.launches["df_project"]
        # The double-word kernels are the file's anonymous-namespace
        # kernels.
        prof = _profile(torch, "ext_conv_profile", op, "(anonymous namespace)",
                        "profile_conv.txt", label="df_kernels",
                        parts={"df_project": "project_kernel",
                               "df_axpy": "axpy_kernel",
                               "df_normalize": "normalize_kernel",
                               "df_basis_change": "basis_kernel",
                               "stencil5_df": "stencil_kernel"}, restarts=3,
                        extended=True, **kw)
        calls = df.KERNEL.launches["df_project"] - calls
        seen.append(prof["df_project_device_launches"])
        if seen[-1] == calls:
            break
    per_step = prof["device_launches"] / prof["mvproducts"]
    check("ext_conv_one_launch",
          calls > 0 and prof["df_project_device_launches"] == calls
          and per_step <= 8,
          wrapper_calls=calls,
          device_launches=prof["df_project_device_launches"],
          device_launches_by_profile=seen,
          device_launches_per_step=per_step,
          dtoh_copies_per_step=prof["dtoh_copies"] / prof["mvproducts"])
    return launches, forms, axpy_forms


def _config3(torch):
    """Config 3's operator on the card (n = 65,536, beta = 2) and its
    keywords but restarts and extended, from numpy seed 3's v1."""
    import numpy as np

    from arnoldimethod_torch.models.problems import convection_diffusion_2d

    nx = 256
    op = convection_diffusion_2d(nx, peclet=4.0 * (nx + 1),
                                 dtype=torch.float32, fmt="stencil",
                                 device="cuda")
    return op, dict(nev=10, which="LM", tol=1e-6, mindim=30, maxdim=60,
                    v1=np.random.default_rng(3).standard_normal(nx * nx))


def _step_host_us(torch, op, reps=300):
    """Host microseconds a call of each wrapper of a double-word Krylov
    step at config 3's shapes (step 30 of a 61 x 65,536 float32-word
    basis), of the whole step (`df_expansion._step`), and of one small
    PyTorch launch (`add_`) as the yardstick: `reps` calls back to back
    between host clocks, no synchronisation inside (the card runs each
    call in less time than the host takes to issue it)."""
    from arnoldimethod_torch.ops import df
    from arnoldimethod_torch.ops import df_expansion as tde

    gen = torch.Generator(device="cuda").manual_seed(5)
    n, m1, j = op.shape[0], 61, 30
    Vh = torch.randn(m1, n, device="cuda", generator=gen) / n ** 0.5
    Vl = torch.zeros_like(Vh)
    Hh, Hl = torch.zeros(m1, m1 - 1, device="cuda"), torch.zeros(m1, m1 - 1,
                                                                 device="cuda")
    flags = torch.zeros(m1 - 1, device="cuda")
    w = op.matvec_df(Vh[j], Vl[j])
    r2 = tde._sumsq(*w)
    h1, w1, s1 = tde._masked_project(Vh, Vl, *w, j + 1, norm=True)
    c, w2, s2 = tde._masked_project(Vh, Vl, *w1, j + 1, norm=True)
    out = (torch.empty_like(Vh[0]), torch.empty_like(Vh[0]))
    step = df.DgksStep(r2, w2, s2, h1, c, (Hh, Hl), j, flags)
    x = torch.zeros(1, device="cuda")
    calls = {
        "stencil5_df": lambda: op.matvec_df(Vh[j], Vl[j]),
        "df_project_one_row": lambda: tde._sumsq(*w),
        "df_project": lambda: df.df_project(Vh, Vl, *w, j + 1),
        "df_axpy_norm": lambda: df.df_axpy(*w, *h1, Vh, Vl, j + 1, True),
        "df_normalize": lambda: df.df_normalize(w1, s1, out, step),
        "step": lambda: tde._step(op, Vh, Vl, Hh, Hl, j, flags),
        "torch_add_": lambda: x.add_(1.0),
    }
    us = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return {"host_us_per_call": us, "reps": reps}


def conv_starts(torch):
    """`--conv-starts`: config 3 (as `ext_conv`, restarts=1000) from
    fourteen starts, one JSON line each: the package's random start for
    seeds 0-4 and v1 = N(0, 1) of numpy seeds 1-9.  How many restarts config
    3 needs depends on the start; this measures the spread."""
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.models.problems import convection_diffusion_2d

    nx = 256
    op = convection_diffusion_2d(nx, peclet=4.0 * (nx + 1),
                                 dtype=torch.float32, fmt="stencil",
                                 device="cuda")
    starts = [(f"seed{s}", {"seed": s}) for s in range(5)] + [
        (f"numpy{s}", {"v1": np.random.default_rng(s).standard_normal(nx * nx)})
        for s in range(1, 10)]
    for name, start in starts:
        t0 = time.perf_counter()
        _, h = partial_schur(op, nev=10, which="LM", tol=1e-6, mindim=30,
                             maxdim=60, restarts=1000, extended=True, **start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        emit({"phase": "conv_starts", "start": name, "converged": h.converged,
              "nconverged": h.nconverged, "restarts": h.restarts,
              "mvproducts": h.mvproducts, "wall_s": wall,
              "ms_per_step": 1e3 * wall / h.mvproducts, "timings": h.timings})


# --- method="device": the restart on the card ----------------------------------

# The card's device-to-device copy rate (phase_roofline sets it).
COPY = {}


def phase_roofline(torch):
    """bench.py's roofline memcpy in the port: a 1 GiB float32 tensor
    copied device to device (read + write counted), CUDA events around
    each copy, median of 20 after 3 warm copies, beside the published
    3.35 TB/s."""
    n = 256 * 1024 * 1024
    src = torch.ones(n, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src), reps=20, warm=3)
    rate = 2 * n * 4 / (ms / 1e3)
    COPY["bytes_s"] = rate
    del src, dst
    torch.cuda.empty_cache()
    check("roofline", rate > 0, copy_bytes=2 * n * 4, copy_ms=ms,
          copy_gbs=rate / 1e9, published_gbs=PEAK_BYTES_S / 1e9,
          share_of_published=rate / PEAK_BYTES_S)


def _arnoldi_h(m, seed, dtype):
    """H of an m-step Arnoldi factorization of a 3m x 3m Gaussian matrix
    (numpy, float64, then cast): Hessenberg with complex Ritz pairs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = 3 * m
    A = rng.standard_normal((n, n))
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    v = rng.standard_normal(n)
    V[0] = v / np.linalg.norm(v)
    for j in range(m):
        w = A @ V[j]
        for _ in range(2):
            h = V[:j + 1] @ w
            w -= h @ V[:j + 1]
            H[:j + 1, j] += h
        H[j + 1, j] = np.linalg.norm(w)
        V[j + 1] = w / H[j + 1, j]
    import torch

    return torch.tensor(H, dtype=dtype)


def _host_core_ms(H0, active, nev, mindim, tol, which, eps, reps=5):
    """One restart's dense phase by the host method's C++ core on the same
    H (float64), with the working dtype's `eps` in the criterion: the steps
    of driver._partial_schur's restart, median of `reps` runs, in ms."""
    import numpy as np

    from arnoldimethod_torch.dense import native
    from arnoldimethod_torch.driver import _is_pair_at, _schur_coupling_floor
    from arnoldimethod_torch.targets import as_target, get_order

    key = get_order(as_target(which))
    m = H0.shape[1]
    H0 = np.ascontiguousarray(H0, dtype=np.float64)

    def once():
        H, Q = H0.copy(), np.eye(m)
        lams, rs = np.zeros(m, complex), np.zeros(m)
        native.local_schur(H[:m, :], active, m, Q)
        native.copy_eigenvalues(lams, H[:m, :], 0, m)
        native.copy_residuals(rs, H[:m, :], Q, H[m, m - 1], active, m)
        _schur_coupling_floor(rs, H, Q, H[m, m - 1], active, m)
        ord_ = sorted(range(m), key=lambda i: (key(lams[i]), i))
        hf = np.linalg.norm(H)
        conv = [rs[i] <= max(eps * hf, tol * abs(lams[i])) for i in ord_]
        eff = nev + int(_is_pair_at(lams, ord_, nev - 1, True))
        groups = np.zeros(m, dtype=int)
        nlock = 0
        for p in range(eff):
            groups[ord_[p]] = 1 if conv[p] else 2
            nlock += conv[p]
        k, p = eff, eff
        ideal = min(nlock + mindim, (mindim + m) // 2)
        while p < m:
            pair = _is_pair_at(lams, ord_, p, True)
            g = 2 if k < ideal and not conv[p] else 3
            k += (2 if pair else 1) if g == 2 else 0
            groups[ord_[p]] = g
            if pair:
                groups[ord_[p + 1]] = g
            p += 2 if pair else 1
        native.partition_three_way(H[:m, :], Q, groups)
        native.restore_arnoldi(H, nlock, k, Q)

    once()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


# A record, not measured here: the restart kernel's times before its
# redesign (run D of PR 11, NVIDIA H100 80GB HBM3 at 700 W), by case and
# word; a case line prints it as earlier_ms beside earlier_ms_is.
EARLIER_RESTART_MS = {("arnoldi_m80", "float32"): 12.3664408,
                      ("arnoldi_m200", "float32"): 95.4865763}
EARLIER_IS = ("record of PR 11 run D (NVIDIA H100 80GB HBM3, 700 W); "
              "not measured in this run")


class _Launch:
    """The restart kernel's measurement settings for a block: the stamps
    and, where not None, the helper forced on or off."""

    def __init__(self, stamping=False, helper=None):
        self.want = stamping, helper

    def __enter__(self):
        from arnoldimethod_torch.dense import device as dd

        self.saved = dd.KERNEL.stamping, dd.KERNEL.helper
        dd.KERNEL.stamping, dd.KERNEL.helper = self.want

    def __exit__(self, *exc):
        from arnoldimethod_torch.dense import device as dd

        dd.KERNEL.stamping, dd.KERNEL.helper = self.saved


def _restart_case(torch, name, H0, S0, flags, kw):
    """The restart kernel against its plain version (on the host, CPU
    tensors) on one input, then the finish kernel on the restart's output;
    returns the line's numbers."""
    from arnoldimethod_torch.dense import device as dd

    m = H0.shape[1]
    dtype = H0.dtype
    word = str(dtype).split(".")[-1]

    def once(dev):
        H = H0.to(dev).clone()
        S = S0.to(dev).clone()
        Qbig = torch.empty((m + 1, m + 1), dtype=dtype, device=dev)
        info = torch.zeros(dd.info_len(m), dtype=torch.int32, device=dev)
        Q = dd.restart(H, Qbig, S, flags.to(dev), info=info, **kw)
        return [t.cpu() for t in (H, Q, Qbig, S, info)]

    # The launch with the stamps, and the one with the helper turned the
    # other way, must give the production launch's bits.
    with _Launch(stamping=True):
        stamped = once("cuda")
        stamps = dd.KERNEL.stamps.tolist()
    storage = dd.KERNEL.storage
    helper = dd.uses_helper(m)
    with _Launch(helper=not helper):
        flipped = once("cuda")
    out = {}
    for dev in ("cpu", "cuda"):
        H = H0.to(dev).clone()
        S = S0.to(dev).clone()
        F = flags.to(dev)
        Qbig = torch.empty((m + 1, m + 1), dtype=dtype, device=dev)
        info = torch.zeros(dd.info_len(m), dtype=torch.int32, device=dev)
        dd.PLAIN_OPS.n = 0
        t0 = time.perf_counter()
        Q = dd.restart(H, Qbig, S, F, info=info, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        restart_ops = dd.PLAIN_OPS.n
        Hr = H.clone()
        lam = torch.empty((2, m), dtype=dtype, device=dev)
        dd.PLAIN_OPS.n = 0
        t1 = time.perf_counter()
        Qf = dd.finish(H, Qbig.clone(), lam, S, kw["which"])
        fin_seconds = time.perf_counter() - t1
        out[dev] = dict(H=Hr, Q=Q, Qbig=Qbig, S=S, info=info, Hf=H, Qf=Qf,
                        lam=lam, s=seconds, fs=fin_seconds, ops=restart_ops,
                        fops=dd.PLAIN_OPS.n)
    c, g = out["cpu"], {k: (v.cpu() if hasattr(v, "cpu") else v)
                        for k, v in out["cuda"].items()}
    ints_equal = torch.equal(c["S"], g["S"]) and torch.equal(c["info"], g["info"])
    floats = ("H", "Q", "Qbig", "Hf", "Qf", "lam")
    scale = max(1.0, float(c["H"].abs().max()))
    err = max(float((c[k].double() - g[k].double()).abs().max()) for k in floats)
    # Equal bits, signed zeros included.
    same = bitwise([(c[k], g[k]) for k in floats])
    production = [g[k] for k in ("H", "Q", "Qbig", "S", "info")]
    variants_same = all(same_bits(v, production) for v in (stamped, flipped))

    # Device time: 20 calls in a CUDA graph, each restoring the input
    # first (two small copies) so every call does the same work.
    Hg0, Sg0, Fg = H0.cuda(), S0.cuda(), flags.cuda()
    Hw, Sw = Hg0.clone(), Sg0.clone()
    Qbw = torch.empty((m + 1, m + 1), dtype=dtype, device="cuda")
    iw = torch.zeros(dd.info_len(m), dtype=torch.int32, device="cuda")
    lamw = torch.empty((2, m), dtype=dtype, device="cuda")
    Hf0 = out["cuda"]["H"].clone()
    Sf0 = out["cuda"]["S"].clone()

    def restart_call():
        Hw.copy_(Hg0)
        Sw.copy_(Sg0)
        dd.restart(Hw, Qbw, Sw, Fg, info=iw, **kw)

    def finish_call():
        Hw.copy_(Hf0)
        dd.finish(Hw, Qbw, lamw, Sf0, kw["which"])

    def copies():
        Hw.copy_(Hg0)
        Sw.copy_(Sg0)

    saved = dd.KERNEL.launches, dd.KERNEL.finish_launches
    copy_ms = graph_ms(copies)
    ms = graph_ms(restart_call) - copy_ms
    fms = graph_ms(finish_call) - graph_ms(lambda: Hw.copy_(Hf0))
    # The measurement's settings against production, in smaller graphs,
    # in the order A B C C B A: the helper off and on, the stamps on.
    settings = {"helper": _Launch(helper=True), "no_helper": _Launch(helper=False),
                "stamped": _Launch(stamping=True)}
    variants_ms = {k: [] for k in settings}
    small_copy_ms = graph_ms(copies, calls=5, reps=6)
    for k in [*settings, *reversed(settings)]:
        with settings[k]:
            variants_ms[k].append(graph_ms(restart_call, calls=5, reps=6)
                                  - small_copy_ms)
    dd.KERNEL.launches, dd.KERNEL.finish_launches = saved
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bound_ms, bound_by = roofline(2 * H0.numel() * H0.element_size(),
                                  c["ops"], word)
    fbound_ms, fbound_by = roofline(2 * H0.numel() * H0.element_size(),
                                    c["fops"], word)
    Hn = H0.double().numpy()
    active = int(S0[0])
    host_ms = _host_core_ms(Hn, active, kw["nev"], kw["mindim"], kw["tol"],
                            kw["which"], torch.finfo(dtype).eps)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    # The kernel's phases from its clock64() stamps: each phase's share of
    # the stamped clocks times the graph's ms, and its clocks at
    # clocks.max.sm.
    clocks = [b - a for a, b in zip(stamps, stamps[1:])]
    total = max(sum(clocks), 1)
    sweeps, steps = g["info"][4 + 2 * m:].tolist()
    res = dict(case=name, m=m, dtype=word, active=active,
               state=g["S"].tolist(), nlock_k_purge=g["info"][:3].tolist(),
               ints_equal=ints_equal, bitwise=same,
               stamped_and_flipped_helper_bitwise=variants_same,
               max_abs_err=err, tolerance=tol * scale,
               storage=storage, helper=helper, sweeps=sweeps, steps=steps,
               phases_ms={p: ms * n / total for p, n in zip(dd.PHASES, clocks)},
               phases_ms_at_max_clock={
                   p: n / (CLOCK_MHZ["sm"] * 1e3) for p, n in zip(dd.PHASES, clocks)},
               us_per_step=1e3 * ms / max(steps, 1),
               ms=ms, variants_ms=variants_ms,
               helper_gain=(statistics.median(variants_ms["no_helper"])
                            / statistics.median(variants_ms["helper"])),
               stamps_cost=(statistics.median(variants_ms["stamped"])
                            / statistics.median(variants_ms[
                                "helper" if helper else "no_helper"])),
               **({"earlier_ms": EARLIER_RESTART_MS[(name, word)],
                   "earlier_ms_is": EARLIER_IS}
                  if (name, word) in EARLIER_RESTART_MS else {}),
               plain_ms=1e3 * c["s"],
               plain_on="host CPU", bound_ms=bound_ms, bound_by=bound_by,
               one_sm_bound_ms=bound_ms * sms, lane_ops=c["ops"],
               library_ms=None, host_core_ms=host_ms,
               finish_ms=fms, finish_plain_ms=1e3 * c["fs"],
               finish_bound_ms=fbound_ms, finish_bound_by=fbound_by,
               finish_one_sm_bound_ms=fbound_ms * sms)
    check("dense_restart_kernel", ints_equal and same and variants_same
          and err <= tol * scale, **res)
    return res


def _captured(torch, run, call=3):
    """Run `run` with the fused loop's restart wrapped; return the input of
    its `call`-th restart launch (H, state, flags, keywords)."""
    from arnoldimethod_torch import fused

    seen, real = [], fused.restart

    def spy(H, Qbig, state, flags, **kw):
        if len(seen) < call:
            seen.append((H.clone(), state.clone(), flags.clone(), kw))
        return real(H, Qbig, state, flags, **kw)

    fused.restart = spy
    try:
        run()
    finally:
        fused.restart = real
    return seen[-1]


def _main_op_v1(torch):
    from arnoldimethod_torch.models.operators import Stencil5Operator

    grid = (1024, 1024)
    op = Stencil5Operator(LAPLACE, grid, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    v1 = torch.randn(grid[0] * grid[1], dtype=torch.float32, device="cuda",
                     generator=gen)
    return op, v1, grid


def phase_dense_restart_helper(torch):
    """The restart kernel with the helper warp on and off on the Arnoldi H
    of m = 20 to 80 in float32 and float64: the same bits either way, and
    ms a call of each (graphs of 5 calls, in the order on, off, off, on)
    beside the setting `dense.device.uses_helper` picks."""
    from arnoldimethod_torch.dense import device as dd

    saved = dd.KERNEL.launches
    rows, all_same = [], True
    for m in (20, 24, 32, 40, 48, 64, 80):
        for dtype in (torch.float32, torch.float64):
            H0 = _arnoldi_h(m, m, dtype).cuda()
            S0 = dd.new_state(0, m, 400).cuda()
            F = torch.zeros(m, dtype=dtype, device="cuda")
            kw = dict(nev=max(2, m // 4), mindim=m // 2, tol=1e-6,
                      restarts=400, which="LM")
            Hw, Sw = H0.clone(), S0.clone()
            Qb = torch.empty((m + 1, m + 1), dtype=dtype, device="cuda")
            info = torch.zeros(dd.info_len(m), dtype=torch.int32, device="cuda")

            def copies():
                Hw.copy_(H0)
                Sw.copy_(S0)

            def call():
                copies()
                return dd.restart(Hw, Qb, Sw, F, info=info, **kw)

            outs = []
            for on in (True, False):
                with _Launch(helper=on):
                    Q = call()
                    outs.append([t.cpu() for t in (Hw, Q, Qb, Sw, info)])
            same = same_bits(*outs)
            all_same = all_same and same
            copy_ms = graph_ms(copies, calls=5, reps=6)
            times = {True: [], False: []}
            for on in (True, False, False, True):
                with _Launch(helper=on):
                    times[on].append(graph_ms(call, calls=5, reps=6) - copy_ms)
            on_ms, off_ms = (statistics.median(times[k]) for k in (True, False))
            rows.append(dict(m=m, dtype=str(dtype).split(".")[-1],
                             storage=dd.KERNEL.storage, bitwise=same,
                             helper_ms=times[True], no_helper_ms=times[False],
                             helper_gain=off_ms / on_ms,
                             uses_helper=dd.uses_helper(m)))
    dd.KERNEL.launches = saved
    check("dense_restart_helper", all_same, cases=rows)


def phase_dense_restart_kernel(torch):
    """The restart and finish kernels against their plain versions: numpy-
    seeded Arnoldi H at m = 20, 80 and 200 in float32 and float64 (complex
    Ritz pairs), a purge case (a restart of a CPU solve whose locked
    vectors are purged), and the H of device_main's third restart.
    Integer outputs (state, nlock, k, purge, effective nev, the order, the
    groups) must be equal, H, Q, Qbig and the finish outputs within the
    stated tolerance (1e-4 in float32, 1e-10 in float64, relative to
    max|H|); `bitwise` says whether they are equal outright."""
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.dense import device as dd

    lines = {}
    for m in (20, 80, 200):
        for dtype in (torch.float32, torch.float64):
            H0 = _arnoldi_h(m, m, dtype)
            kw = dict(nev=max(2, m // 4), mindim=m // 2, tol=1e-6,
                      restarts=400, which="LM")
            lines[(m, dtype)] = _restart_case(
                torch, f"arnoldi_m{m}", H0, dd.new_state(0, m, 400),
                torch.zeros(m, dtype=dtype), kw)

    # A purge: diag(11, 10.999, 10, ...) from a start almost orthogonal to
    # the two largest (the JAX package's purge test), on the CPU.
    n = 100
    A = np.diag(np.concatenate([[11.0, 10.999, 10.0, 9.5, 9.0],
                                np.linspace(1.0, 8.0, n - 5)]))
    v1 = np.ones(n)
    v1[0] = v1[1] = 1e-12
    seen = []
    from arnoldimethod_torch import fused

    real = fused.restart

    def spy(H, Qbig, state, flags, **kw):
        before = int(state[dd.STATE["purges"]])
        snap = (H.clone(), state.clone(), flags.clone(), kw)
        q = real(H, Qbig, state, flags, **kw)
        if int(state[dd.STATE["purges"]]) > before and not seen:
            seen.append(snap)
        return q

    fused.restart = spy
    try:
        partial_schur(A, v1=v1, nev=3, which="LM", tol=1e-8, method="device",
                      device="cpu")
    finally:
        fused.restart = real
    H0, S0, F0, kw = seen[0]
    kw = {k: v for k, v in kw.items() if k != "maxiter"}
    purge = _restart_case(torch, "purge", H0, S0, F0, kw)

    op, v1, _ = _main_op_v1(torch)
    H0, S0, F0, kw = _captured(torch, lambda: partial_schur(
        op, v1=v1, restarts=3, method="device", **MAIN_KW))
    kw = {k: v for k, v in kw.items() if k != "maxiter"}
    captured = _restart_case(torch, "device_main_restart3", H0.cpu(),
                             S0.cpu(), F0.cpu(), kw)
    phase_dense_restart_helper(torch)
    return lines, purge, captured


def phase_device_readme(torch):
    """The README configuration with method="device" on the card (the
    restart kernel) and on the CPU (its plain version) from one v1: the
    same matvec and restart counts."""
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.dense import device as dd
    from arnoldimethod_torch.models.problems import laplacian_1d

    v1 = np.random.default_rng(0).standard_normal(100)
    out = {}
    for dev in ("cuda", "cpu"):
        dd.KERNEL.launches = 0
        op = laplacian_1d(100, dtype=torch.float32, device=dev)
        d, h = partial_schur(op, v1=v1, nev=10, which="SR", tol=1e-6,
                             method="device")
        out[dev] = (d, h, dd.KERNEL.launches)
    (dg, hg, lg), (dc, hc, lc) = out["cuda"], out["cpu"]
    lam_err = float(np.abs(np.sort(dg.eigenvalues.real)
                           - np.sort(dc.eigenvalues.real)).max())
    check("device_readme", hg.converged and lg >= hg.restarts > 0 and lc == 0
          and (hg.mvproducts, hg.restarts) == (hc.mvproducts, hc.restarts),
          mvproducts_cuda=hg.mvproducts, mvproducts_cpu=hc.mvproducts,
          restarts_cuda=hg.restarts, restarts_cpu=hc.restarts,
          jax_cpu_device_mvproducts=167, jax_cpu_device_restarts=19,
          dense_restart_launches=lg, host_syncs=hg.host_syncs,
          lam_err_card_vs_cpu=lam_err)


def phase_device_main(torch):
    """Config 2 with method="device" (bench.py's e2e_1m_device) and with
    method="host" from one v1, in the same call.  The device run is driven
    once with every count at 0; two more runs of each method in turns give
    median walls of 3; then 3-restart profiles of both.  Returns the
    launches of the stencil, restart and finish kernels in the driven
    run."""
    import numpy as np

    from arnoldimethod_torch import partial_schur
    from arnoldimethod_torch.dense import device as dd
    from arnoldimethod_torch.ops import stencil
    from arnoldimethod_torch.ops.expansion import LOWSYNC

    op, v1, grid = _main_op_v1(torch)
    kw = dict(MAIN_KW, restarts=400)

    def solve(method):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, h = partial_schur(op, v1=v1, method=method, **kw)
        torch.cuda.synchronize()
        return d, h, time.perf_counter() - t0

    stencil.KERNEL.launches = 0
    dd.KERNEL.launches = dd.KERNEL.finish_launches = 0
    LOWSYNC.rollbacks = LOWSYNC.discarded_matvecs = 0
    d, h, wall = solve("device")
    launches = dict(stencil5=stencil.KERNEL.launches,
                    dense_restart=dd.KERNEL.launches,
                    dense_finish=dd.KERNEL.finish_launches)
    rollbacks, discarded = LOWSYNC.rollbacks, LOWSYNC.discarded_matvecs
    walls, host_walls = [wall], []
    for _ in range(2):
        dh, host, w = solve("host")
        host_walls.append(w)
        walls.append(solve("device")[2])
    dh, host, w = solve("host")
    host_walls.append(w)

    lam_exact = 0.130 * (4 - 4 * math.cos(math.pi / 1025))
    lam_min = float(np.min(d.eigenvalues.real))
    resid = _stencil_resid(d.Q, d.R, LAPLACE, grid)
    host_lam = float(np.min(dh.eigenvalues.real))
    del d, dh
    parts = dict(MAIN_PARTS, restart="restart_kernel")
    prof = _profile(torch, "device_profile", op, "restart_kernel",
                    "profile_device.txt", parts=parts, **MAIN_KW,
                    restarts=3, v1=v1, method="device")
    hprof = _profile(torch, "device_host_profile", op, "stencil5",
                     "profile_device_host.txt", parts=MAIN_PARTS, **MAIN_KW,
                     restarts=3, v1=v1, method="host")
    keys = ("device_busy_share", "device_busy_s", "device_launches",
            "dtoh_copies", "wall_s", "restarts", "mvproducts")
    sync_limit = h.restarts + rollbacks + 1
    check("device_main", h.converged and h.nconverged == 20
          and abs(lam_min - lam_exact) <= 1e-5 and resid <= 1e-5
          and h.host_syncs <= sync_limit
          and launches["stencil5"] == h.mvproducts + discarded
          and launches["dense_restart"] >= h.restarts
          and launches["dense_finish"] == 1,
          n=grid[0] * grid[1], mvproducts=h.mvproducts, restarts=h.restarts,
          nconverged=h.nconverged, purges=h.purges, host_syncs=h.host_syncs,
          host_sync_limit=sync_limit,
          reads_per_restart=h.host_syncs / max(h.restarts, 1),
          rollbacks=rollbacks, discarded_matvecs=discarded,
          launches=launches, wall_s_median=statistics.median(walls),
          walls_s=walls,
          device_over_host_wall=statistics.median(walls) / statistics.median(host_walls),
          lam_min=lam_min, lam_exact=lam_exact,
          lam_min_err=abs(lam_min - lam_exact), schur_residual=resid,
          profile={k: prof[k] for k in keys} | {
              "restart_device_ms": prof["restart_device_ms"],
              "restart_share_of_device": prof["restart_share_of_device"],
              "stencil_device_ms": prof["stencil_device_ms"],
              "gemv_device_ms": prof["gemv_device_ms"]},
          host={"mvproducts": host.mvproducts, "restarts": host.restarts,
                "converged": host.converged, "host_syncs": host.host_syncs,
                "reads_per_restart": host.host_syncs / host.restarts,
                "dense_s": host.timings["dense"],
                "dense_ms_per_restart": 1e3 * host.timings["dense"] / host.restarts,
                "lam_min_err": abs(host_lam - lam_exact),
                "wall_s_median": statistics.median(host_walls),
                "walls_s": host_walls,
                "profile": {k: hprof[k] for k in keys}},
          jax_tpu_record={"source": "BENCH_r05.json (JAX on a TPU)",
                          "mvproducts": 10332, "restarts": 357,
                          "wall_s_warm": 70.9})
    return launches


# -- The row-sharded solver (arnoldimethod_torch/parallel/) ----------------

SHARDED_LABEL = ("two ranks sharing one card through gloo (not a multi-GPU "
                 "figure)")


def _laplace_csr(grid):
    """Config 2's matrix as float32 CSR arrays (indptr, indices, data): the
    0.130-scaled 5-point Dirichlet Laplacian the stencil applies, built with
    scipy.sparse."""
    import numpy as np
    import scipy.sparse as sp

    def lap(k):
        return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))

    ny, nx = grid
    A = 0.130 * (sp.kron(sp.identity(ny), lap(nx))
                 + sp.kron(lap(ny), sp.identity(nx)))
    A = A.tocsr().astype(np.float32)
    A.sort_indices()
    return A.indptr, A.indices, A.data


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _per_step(counts, steps):
    """Collectives a Krylov step by kind: calls and bytes."""
    return {k: {"calls": v["calls"] / steps, "bytes": v["bytes"] / steps}
            for k, v in counts.items() if v["calls"]}


def _sharded_counts_zero():
    from arnoldimethod_torch.dense import device as dd
    from arnoldimethod_torch.ops import stencil
    from arnoldimethod_torch.ops.expansion import LOWSYNC
    from arnoldimethod_torch.parallel import COLLECTIVES

    COLLECTIVES.reset()
    stencil.KERNEL.launches = 0
    dd.KERNEL.launches = dd.KERNEL.finish_launches = 0
    LOWSYNC.rollbacks = LOWSYNC.discarded_matvecs = 0


def _sharded_counts():
    from arnoldimethod_torch.dense import device as dd
    from arnoldimethod_torch.ops import stencil
    from arnoldimethod_torch.ops.expansion import LOWSYNC
    from arnoldimethod_torch.parallel import COLLECTIVES

    return dict(collectives=COLLECTIVES.snapshot(),
                launches={"stencil5": stencil.KERNEL.launches,
                          "dense_restart": dd.KERNEL.launches,
                          "dense_finish": dd.KERNEL.finish_launches},
                rollbacks=LOWSYNC.rollbacks,
                discarded_matvecs=LOWSYNC.discarded_matvecs)


def _timed_solve(torch, op, **kw):
    from arnoldimethod_torch import partial_schur

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, h = partial_schur(op, **kw)
    torch.cuda.synchronize()
    return d, h, time.perf_counter() - t0


def _config2_ok(h, lam_min, resid):
    lam_exact = 0.130 * (4 - 4 * math.cos(math.pi / 1025))
    return (h.converged and h.nconverged == 20
            and abs(lam_min - lam_exact) <= 1e-5 and resid <= 1e-5)


def _comm_us(torch, comm, m=80, calls=300, warm=2500):
    """Microseconds a call of each collective the sharded step makes, on
    CUDA tensors, back to back: host time to return, and the time until the
    device has finished them too; beside a torch add_ on the same buffer.
    The buffers are a step's m + 2 sums, a basis row (the gather) and the
    halo of a 1024-wide band.  `warm` calls first, more than the NCCL
    flight recorder keeps (2,000 by default), as in a long solve."""
    buf = torch.zeros(m + 2, device="cuda")
    row = torch.zeros(comm.n_local, device="cuda")
    out = {}
    for name, fn in (("torch_add_", lambda: buf.add_(1.0)),
                     ("all_reduce_", lambda: comm.all_reduce_(buf)),
                     ("gather_rows", lambda: comm.gather_rows(row)),
                     ("halo", lambda: comm.halo(row, 1024, 1024))):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        done = time.perf_counter() - t0
        out[name] = {"host_us": 1e6 * host / calls, "done_us": 1e6 * done / calls}
    return out


def _comm_costs_process(env):
    """`--comm-costs` in a fresh process with `env` added: its "us" (each
    collective's microseconds, and again after 40,000 all-reduces)."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--comm-costs"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, **env})
    for line in proc.stdout.splitlines():
        if line.startswith('{"phase": "comm_costs"'):
            return json.loads(line)["us"]
    check("comm_costs", False, returncode=proc.returncode,
          stderr=proc.stderr[-2000:])


def comm_costs(torch):
    """`--comm-costs`: `_comm_us` on a one-rank NCCL group at config 2's n
    (sharded_p1 runs it in a fresh process with and without the NCCL
    flight recorder)."""
    import torch.distributed as dist

    from arnoldimethod_torch.parallel import basis_sharding, make_mesh, row_comm

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        comm = row_comm(basis_sharding(make_mesh()), 1 << 20)
        us = _comm_us(torch, comm)
        # Again after as many all-reduces as a config 2 solve makes.
        buf = torch.zeros(82, device="cuda")
        for _ in range(40000):
            comm.all_reduce_(buf)
        us["after_40000_all_reduces"] = _comm_us(torch, comm, warm=0)
        check("comm_costs", True, backend="nccl", world_size=1, us=us)
    finally:
        dist.destroy_process_group()


def _sharded_ways(torch, stencil_op, csr):
    """sharded_p1's three ways: (operator, keywords)."""
    return {"dgks": (csr, dict(method="host")),
            "lowsync": (csr, dict(method="host", lowsync=True)),
            "device": (stencil_op, dict(method="device"))}


def phase_sharded_p1(torch):
    """Config 2 on a one-rank NCCL group, three ways from one v1, each
    beside its unsharded solve in this call: (a) the scipy CSR matrix
    through shard_operator (a ShardedCsrOperator) with the host DGKS
    method, (b) the same with lowsync=True, (c) method="device" with the
    stencil through the gathering wrapper (K1 and the restart kernel
    launch).  Q, R and the counts must equal the unsharded solve's bit for
    bit.  Each sharded run is driven with the counts at 0 just before it
    and read just after.  Returns the kernels' launches over the three."""
    import numpy as np
    import torch.distributed as dist

    from arnoldimethod_torch.models.operators import CsrOperator
    from arnoldimethod_torch.parallel import (
        basis_sharding,
        make_mesh,
        row_comm,
        shard_operator,
    )

    stencil_op, v1, grid = _main_op_v1(torch)
    n = grid[0] * grid[1]
    csr = CsrOperator(*_laplace_csr(grid), (n, n), device="cuda")
    kw = dict(MAIN_KW, restarts=400, v1=v1)
    launches = dict.fromkeys(("stencil5", "dense_restart", "dense_finish"), 0)
    ways, ok = {}, True
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        sharding = basis_sharding(mesh)
        for way, (op, extra) in _sharded_ways(torch, stencil_op, csr).items():
            d0, h0, wall0 = _timed_solve(torch, op, **kw, **extra)
            sop = shard_operator(op, mesh)
            _sharded_counts_zero()
            d1, h1, wall1 = _timed_solve(torch, sop, sharding=sharding, **kw,
                                         **extra)
            counts = _sharded_counts()
            for k in launches:
                launches[k] += counts["launches"][k]
            Q1 = d1.Q.to_local()
            same = (bitwise([(Q1, d0.Q)])
                    and np.array_equal(d1.R, d0.R)
                    and np.array_equal(np.signbit(d1.R), np.signbit(d0.R))
                    and (h1.mvproducts, h1.restarts, h1.host_syncs)
                    == (h0.mvproducts, h0.restarts, h0.host_syncs))
            lam_min = float(np.min(d1.eigenvalues.real))
            resid = _stencil_resid(Q1, d1.R, LAPLACE, grid)
            kernels_ok = way != "device" or (
                counts["launches"]["stencil5"] >= h1.mvproducts
                and counts["launches"]["dense_restart"] >= h1.restarts)
            ok = ok and same and kernels_ok and _config2_ok(h1, lam_min, resid)
            ways[way] = dict(
                operator=type(sop).__name__,
                gather=getattr(sop, "mode", "all (wrapper)"),
                bitwise_q_r_counts=same, mvproducts=h1.mvproducts,
                restarts=h1.restarts, nconverged=h1.nconverged,
                host_syncs=h1.host_syncs,
                host_reads_per_step=h1.host_syncs / h1.mvproducts,
                collectives=counts["collectives"],
                collectives_per_step=_per_step(counts["collectives"],
                                               h1.mvproducts),
                launches=counts["launches"], rollbacks=counts["rollbacks"],
                wall_s=wall1, unsharded_wall_s=wall0,
                sharded_over_unsharded_wall=wall1 / wall0,
                lam_min=lam_min, schur_residual=resid)
            del d0, d1, Q1
        comm_us = _comm_us(torch, row_comm(sharding, n))
        comm_us_fresh = {label: _comm_costs_process(env) for label, env in (
            ("default", {}),
            ("flight_recorder_off", {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0",
                                     "TORCH_FR_BUFFER_SIZE": "0"}))}
        for way in ("dgks", "device"):
            op, extra = _sharded_ways(torch, stencil_op, csr)[way]
            _profile(torch, f"sharded_p1_profile_{way}", shard_operator(op, mesh),
                     "stencil5", f"profile_sharded_{way}.txt",
                     parts={"gemv": "gemv", "nccl": "nccl"}, **MAIN_KW,
                     restarts=3, v1=v1, sharding=sharding, **extra)
    finally:
        dist.destroy_process_group()
    check("sharded_p1", ok, n=n, world_size=1, backend="nccl",
          q_type="DTensor Shard(0)", ways=ways, launches=launches,
          comm_us=comm_us, comm_us_fresh_process=comm_us_fresh)
    return launches


def _probe_collectives(torch, comm):
    """Each collective the comm layer makes, on CUDA tensors through this
    rank's process group: True, False (wrong values) or the error."""
    rank, p = comm.rank, comm.size
    dev = torch.device("cuda")
    out = {}

    def probe(name, fn):
        try:
            out[name] = bool(fn())
        except Exception as e:  # noqa: BLE001  (reported, then the phase fails)
            out[name] = f"{type(e).__name__}: {e}"[:300]

    total = float(sum(range(1, p + 1)))
    probe("all_reduce", lambda: torch.equal(
        comm.all_reduce_(torch.full((3,), rank + 1.0, device=dev)),
        torch.full((3,), total, device=dev)))
    probe("all_reduce_complex", lambda: torch.equal(
        comm.all_reduce_(torch.full((3,), complex(rank + 1, -rank - 1),
                                    dtype=torch.complex64, device=dev)),
        torch.full((3,), complex(total, -total), dtype=torch.complex64,
                   device=dev)))
    x = torch.arange(comm.n_local, dtype=torch.float32, device=dev) + comm.offset
    whole = torch.arange(comm.n, dtype=torch.float32, device=dev)
    probe("all_gather_into_tensor",
          lambda: torch.equal(comm.gather_rows(x), whole))

    def exchange():
        splits = [0 if t == rank else 1 for t in range(p)]
        send = torch.tensor([100.0 * rank + t for t in range(p) if t != rank],
                            device=dev)
        got, work = comm.exchange(send, splits, splits)
        work.wait()
        want = [100.0 * s + rank for s in range(p) if s != rank]
        return torch.equal(got, torch.tensor(want, device=dev))

    probe("all_to_all_single_async", exchange)
    lo = hi = 2
    xp = torch.nn.functional.pad(whole, (lo, hi))
    probe("halo", lambda: torch.equal(
        comm.halo(x, lo, hi), xp[comm.offset:comm.offset + comm.n_local + lo + hi]))
    return out


# sharded_p2's runs: (operator, gather mode, keywords).  Both DGKS runs go
# to convergence; lowsync and method="device" run P2_SHORT restarts: at two
# ranks on one card every collective stages through the host and each run
# to convergence takes 68-87 s (PERF.md, PR 14), which would take the
# script past half its time limit.
P2_SHORT = 5
P2_RUNS = {
    "dgks_footprint": ("csr", "footprint", dict(method="host", restarts=400)),
    "dgks_all": ("csr", "all", dict(method="host", restarts=400)),
    "lowsync_footprint": ("csr", "footprint", dict(
        method="host", lowsync=True, restarts=P2_SHORT)),
    "device": ("stencil", None, dict(method="device", restarts=P2_SHORT)),
}


def sharded_rank(torch, rank, world, init, out_dir):
    """`--sharded-rank RANK WORLD INIT OUT`: one rank of sharded_p2 on
    cuda:0 through gloo.  Probes the collectives, then runs P2_RUNS from
    one v1, each driven with the counts at 0; writes OUT/rank<RANK>.json."""
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from arnoldimethod_torch.models.operators import ShardedCsrOperator
    from arnoldimethod_torch.parallel import (
        basis_sharding,
        make_mesh,
        row_comm,
        shard_operator,
    )

    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=600))
    result = {"rank": rank}
    try:
        mesh = make_mesh()
        sharding = basis_sharding(mesh)
        stencil_op, v1, grid = _main_op_v1(torch)
        n = grid[0] * grid[1]
        result["probe"] = _probe_collectives(torch, row_comm(sharding, n))
        print("probe", result["probe"], flush=True)
        if not all(v is True for v in result["probe"].values()):
            return
        csr = _laplace_csr(grid)
        kw = dict(MAIN_KW, v1=v1)
        runs = {}
        for name, (kind, gather, extra) in P2_RUNS.items():
            t0 = time.perf_counter()
            if kind == "csr":
                op = ShardedCsrOperator.build(*csr, (n, n), mesh, gather=gather)
            else:
                op = shard_operator(stencil_op, mesh)
            build_s = time.perf_counter() - t0
            print(name, "built in", build_s, "s", flush=True)
            dist.barrier()
            _sharded_counts_zero()
            d, h, wall = _timed_solve(torch, op, sharding=sharding, **kw,
                                      **extra)
            counts = _sharded_counts()
            # The port's gather: DTensor.full_tensor() on gloo with CUDA
            # tensors crashes torch 2.11 (a segmentation fault in
            # wait_tensor).
            Q = row_comm(sharding, n).gather_rows(d.Q.to_local())
            run = dict(operator=type(op).__name__,
                       gather=getattr(op, "mode", "all (wrapper)"),
                       footprint_elems=getattr(op, "footprint_elems", 0),
                       build_s=build_s, mvproducts=h.mvproducts,
                       restarts=h.restarts, nconverged=h.nconverged,
                       converged=h.converged, host_syncs=h.host_syncs,
                       wall_s=wall, **counts,
                       collectives_per_step=_per_step(counts["collectives"],
                                                      h.mvproducts),
                       eigenvalues=sorted(float(x) for x in
                                          np.real(d.eigenvalues)))
            if rank == 0 and h.nconverged:
                run["lam_min"] = run["eigenvalues"][0]
                run["schur_residual"] = _stencil_resid(Q, d.R, LAPLACE, grid)
            runs[name] = run
            print(name, {k: run[k] for k in ("mvproducts", "restarts",
                                              "wall_s")}, flush=True)
            del d, Q, op
        result["runs"] = runs
        dist.barrier()
        result["wide_dia"] = _wide_dia_run(torch, sharding, extended=False)
        print("wide_dia", result["wide_dia"], flush=True)
    finally:
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)


def _two_ranks(phase, flag, subdir, timeout):
    """Two processes on cuda:0 through gloo, each `chip_smoke.py FLAG RANK
    2 file://... OUT` (logs and JSON in chiprun_out/SUBDIR/): every rank's
    JSON and the seconds taken.  Fails the phase, with the logs' tails,
    when a rank exits non-zero, hangs past `timeout` or writes no JSON."""
    world = 2
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", subdir)
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        os.unlink(os.path.join(out_dir, name))
    init = f"file://{os.path.join(out_dir, 'rendezvous')}"
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
         flag, str(r), str(world), init, out_dir], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        rcs = [p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
    if rcs is None or rcs != [0] * world or len(results) != world:
        tails = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tails.append(f.read()[-2000:])
        check(phase, False, returncodes=rcs, seconds=wall,
              probe=[r.get("probe") for r in results], log_tails=tails)
    return results, wall


def phase_sharded_p2(torch, timeout=900):
    """Config 2 on two processes that share cuda:0 through gloo (NCCL
    refuses two ranks on one device): the CSR matrix split over 2 ranks
    with DGKS in both gather modes to convergence, and lowsync=True and
    method="device" (the stencil through the gathering wrapper) for
    P2_SHORT restarts.  Each run must meet config 2's limits on rank 0 (or
    run its restarts) and give both ranks the same counts.  Then a DIA
    band wider than a rank's rows (WIDE_BAND > n / 2, F8) in float64: the
    unsharded solve's counts and eigenvalues on both ranks.  Returns the
    kernels' launches summed over the ranks."""
    results, wall = _two_ranks("sharded_p2", "--sharded-rank", "sharded_p2",
                               timeout)
    world = len(results)
    probe = results[0]["probe"]
    ok = all(v is True for r in results for v in r["probe"].values())
    runs, launches = {}, dict.fromkeys(("stencil5", "dense_restart",
                                        "dense_finish"), 0)
    for name in P2_RUNS if ok else ():
        r0, r1 = (r["runs"][name] for r in results)
        keys = ("mvproducts", "restarts", "nconverged", "host_syncs",
                "eigenvalues")
        agree = all(r0[k] == r1[k] for k in keys)
        lam_exact = 0.130 * (4 - 4 * math.cos(math.pi / 1025))
        short = P2_RUNS[name][2]["restarts"] == P2_SHORT
        meets = (r0["restarts"] == P2_SHORT if short else
                 r0["converged"] and r0["nconverged"] == 20
                 and abs(r0["lam_min"] - lam_exact) <= 1e-5
                 and r0["schur_residual"] <= 1e-5)
        kernels_ok = name != "device" or all(
            r["runs"][name]["launches"]["stencil5"] >= r0["mvproducts"]
            and r["runs"][name]["launches"]["dense_restart"] >= r0["restarts"]
            for r in results)
        ok = ok and agree and meets and kernels_ok
        for k in launches:
            launches[k] += sum(r["runs"][name]["launches"][k] for r in results)
        runs[name] = dict(
            {k: r0.get(k) for k in ("operator", "gather", "footprint_elems",
                                    "build_s", "mvproducts", "restarts",
                                    "nconverged", "host_syncs", "rollbacks",
                                    "collectives_per_step", "lam_min",
                                    "schur_residual")},
            ranks_agree=agree, restarts_cut_to=P2_SHORT if short else None,
            lam_min_err=None if short else abs(r0["lam_min"] - lam_exact),
            host_reads_per_step=r0["host_syncs"] / r0["mvproducts"],
            launches_by_rank=[r["runs"][name]["launches"] for r in results],
            walls_s_by_rank=[r["runs"][name]["wall_s"] for r in results],
            wall_label=SHARDED_LABEL)
    wide = [r.get("wide_dia") for r in results]
    wide_ok = all(wide) and _wide_dia_ok(wide)
    check("sharded_p2", ok and wide_ok, world_size=world,
          backend="gloo (CUDA tensors)", device="cuda:0 shared by both ranks",
          probe=probe, seconds=wall, runs=runs, launches=launches,
          wide_dia=dict(wide[0] or {}, ok=wide_ok, wall_label=SHARDED_LABEL))
    return launches


def _ext_counts_zero():
    """sharded counts and the double-word kernels' to 0."""
    from arnoldimethod_torch.ops import df, df32

    _sharded_counts_zero()
    df.KERNEL.launches = dict.fromkeys(df.KERNEL.launches, 0)
    df.KERNEL.gathered = dict.fromkeys(df.KERNEL.gathered, 0)
    df32.PLAIN_ON_CARD = 0


def _ext_counts():
    from arnoldimethod_torch.ops import df, df32

    return dict(_sharded_counts(), df_launches=dict(df.KERNEL.launches),
                gathered_launches=dict(df.KERNEL.gathered),
                plain_df_calls_on_card=df32.PLAIN_ON_CARD)


# A DIA band wider than a rank's rows at two ranks (F8): the 1-D Laplacian
# with -1/4 at +-WIDE_BAND, n = WIDE_N (tests/torch_parallel_worker.py's
# wide_band).
WIDE_N, WIDE_BAND = 256, 150


def wide_band(n, band, dtype):
    """(diags, offsets) of that matrix: diags[d, i] = A[i, i + offsets[d]],
    zero where out of range."""
    import numpy as np

    offsets = (-band, -1, 0, 1, band)
    i = np.arange(n)
    diags = np.zeros((len(offsets), n), dtype=dtype)
    for d, (off, v) in enumerate(zip(offsets, (-0.25, -1.0, 2.0, -1.0,
                                               -0.25))):
        diags[d, (i + off >= 0) & (i + off < n)] = v
    return diags, offsets


def _wide_dia_run(torch, sharding, extended):
    """The wide-band DIA solve on the card, sharded over `sharding`'s mesh
    (driven with the counts at 0 just before it and read just after) and
    unsharded, from one v1: float64 with the host method, or float32 words
    with extended=True.  Counts, eigenvalues, the halo a matvec."""
    import numpy as np

    from arnoldimethod_torch.models.operators import DiaOperator
    from arnoldimethod_torch.parallel import shard_operator

    op = DiaOperator(*wide_band(WIDE_N, WIDE_BAND,
                                np.float32 if extended else np.float64),
                     (WIDE_N, WIDE_N), device="cuda")
    kw = dict(nev=4, which="SR", tol=1e-12 if extended else 1e-8,
              extended=extended,
              v1=np.random.default_rng(5).standard_normal(WIDE_N))
    sop = shard_operator(op, sharding.mesh)
    _ext_counts_zero()
    d, h, wall = _timed_solve(torch, sop, sharding=sharding, **kw)
    counts = _ext_counts()
    d0, h0, wall0 = _timed_solve(torch, op, **kw)
    lam = np.sort(np.real(np.asarray(d.eigenvalues)))
    lam0 = np.sort(np.real(np.asarray(d0.eigenvalues)))
    return dict(operator=type(sop).__name__, n=WIDE_N, band=WIDE_BAND,
                ranks=sop.comm.size, n_local=sop.comm.n_local,
                extended=extended,
                mvproducts=h.mvproducts, restarts=h.restarts,
                converged=h.converged, nconverged=h.nconverged,
                unsharded_mvproducts=h0.mvproducts,
                unsharded_restarts=h0.restarts,
                eigenvalues=[float(x) for x in lam],
                eigenvalue_diff=float(np.abs(lam - lam0).max()),
                collectives_per_step=_per_step(counts["collectives"],
                                               h.mvproducts),
                df_launches=counts["df_launches"],
                gathered_launches=counts["gathered_launches"],
                wall_s=wall, unsharded_wall_s=wall0)


def _wide_dia_ok(runs):
    """Every rank's wide-band run: converged with the unsharded solve's
    counts and eigenvalues (to 1e-10), the ranks' counts and eigenvalues
    equal, a halo a matvec on more than one rank."""
    r0 = runs[0]
    return all(
        r["converged"] and r["nconverged"] >= 4
        and (r["mvproducts"], r["restarts"])
        == (r["unsharded_mvproducts"], r["unsharded_restarts"])
        == (r0["mvproducts"], r0["restarts"])
        and r["eigenvalues"] == r0["eigenvalues"]
        and r["eigenvalue_diff"] <= 1e-10
        and r["collectives_per_step"].get("halo", {}).get("calls", 0)
        >= (r["ranks"] > 1) for r in runs)


def _rank_sum_step(op, Vh, Vl, Hh, Hl, j, flags, comm):
    """The sharded Krylov step with a launch of its own a sum: each sum over
    the ranks one df_sum (a gather, then a df_rank_sum launch), then
    df_axpy and df_normalize on the sums.  The reference the gathered step
    (ops/df_expansion.py _step) must equal bit for bit."""
    from arnoldimethod_torch.ops import df
    from arnoldimethod_torch.ops import df_expansion as tde

    rows = j + 1
    wh, wl = tde._matvec_df(op, Vh[j], Vl[j])
    sh, sl = comm.df_sum([tde._sumsq(wh, wl),
                          df.df_project(Vh, Vl, wh, wl, rows)])
    r2, h1 = (sh[0], sl[0]), (sh[1:], sl[1:])
    w1, s1 = df.df_axpy(wh, wl, *h1, Vh, Vl, rows, True)
    sh, sl = comm.df_sum([s1, df.df_project(Vh, Vl, *w1, rows)])
    s1, c = (sh[0], sl[0]), (sh[1:], sl[1:])
    w2, s2 = df.df_axpy(*w1, *c, Vh, Vl, rows, True)
    sh, sl = comm.df_sum([s2])
    df.df_normalize(w1, s1, (Vh[rows], Vl[rows]), df.DgksStep(
        r2, w2, (sh[0], sl[0]), h1, c, (Hh, Hl), j, flags))


def _ext_step_us(torch, op, comm, v1, m=60, j=30, calls=200):
    """One sharded Krylov step of the extended range (ops/df_expansion.py
    _step, the gathered forms) beside its df_rank_sum form
    (`_rank_sum_step`) on one state: a basis of m + 1 rows in float32
    words started from v1 (global) and expanded to step j.  Step j reads rows 0..j and writes row j + 1, H's
    column j and flags[j], so each call repeats the same work.  Both ways'
    outputs bitwise equal; the host microseconds of each call, `calls`
    calls of each way in turn (the first way alternating): medians and
    quartiles, and host_us_saved, the df_rank_sum form's median less the
    gathered one's; at one rank also the unsharded step's on the whole
    operator (op.op)."""
    from arnoldimethod_torch.ops import df_expansion as tde

    Vh = torch.zeros(m + 1, comm.n_local, device="cuda")
    Vl = torch.zeros_like(Vh)
    Hh, Hl = torch.zeros(m + 1, m, device="cuda"), torch.zeros(m + 1, m,
                                                               device="cuda")
    flags = torch.zeros(m, device="cuda")
    tde.df_set_initial_vector(
        Vh, Vl, comm.local(torch.as_tensor(v1, device="cuda")), comm)
    tde.df_expand_range(op, Vh, Vl, Hh, Hl, 0, j,
                        torch.Generator(device="cuda").manual_seed(0), comm)
    ways = {"gathered": lambda: tde._step(op, Vh, Vl, Hh, Hl, j, flags, comm),
            "rank_sum": lambda: _rank_sum_step(op, Vh, Vl, Hh, Hl, j, flags,
                                               comm)}
    if comm.size == 1 and hasattr(op, "op"):
        ways["unsharded"] = lambda: tde._step(op.op, Vh, Vl, Hh, Hl, j, flags)
    outputs = {}
    for name, fn in ways.items():
        fn()
        torch.cuda.synchronize()
        outputs[name] = [t.clone() for t in (Vh[j + 1], Vl[j + 1], Hh[:, j],
                                             Hl[:, j], flags[j:j + 1])]
    torch.cuda.synchronize()
    times = {name: [] for name in ways}
    for c in range(calls):
        # The ways in turn, the first of them alternating.
        for name in list(ways)[c % 2:] + list(ways)[:c % 2]:
            t0 = time.perf_counter()
            ways[name]()
            times[name].append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    us = {name: {"median": statistics.median(t),
                 "quartiles": statistics.quantiles(t, n=4)[::2]}
          for name, t in times.items()}
    return dict(
        bitwise=all(bitwise(zip(outputs["gathered"], o))
                    for o in outputs.values()),
        # H's column and the flag are the same on every rank (the row is
        # each rank's own columns).
        digest=_digest(torch.cat(outputs["gathered"][2:]).cpu().numpy()),
        ranks=comm.size, j=j, m=m, calls=calls, host_us=us,
        host_us_saved=us["rank_sum"]["median"] - us["gathered"]["median"])


def _digest(a):
    """A short hash of an array's bytes, to compare ranks' results."""
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _ext_comm_us(torch, comm, sop, k=62, calls=300, warm=300):
    """Host microseconds a call of what a sharded extended step adds, back
    to back on CUDA tensors, and the time until the device has finished
    them too: df_sum of a step's {r2, h1} (k pairs), its parts (the
    concatenation, the all_gather_into_tensor alone, df_rank_sum alone),
    gather_partials (the gather a Krylov step makes in place of df_sum),
    and the wrapper's matvec_df (the gather of both words, stencil5_df on
    the full grid) beside the unsharded operator's; a torch add_ for
    scale."""
    import torch.distributed as dist

    from arnoldimethod_torch.ops import df

    r2 = (torch.ones((), device="cuda"), torch.zeros((), device="cuda"))
    h1 = (torch.ones(k - 1, device="cuda"), torch.zeros(k - 1, device="cuda"))
    send = torch.zeros(2 * k, device="cuda")
    buf = torch.zeros(comm.size * 2 * k, device="cuda")
    parts = buf.view(comm.size, 2 * k)
    xh = torch.ones(comm.n_local, device="cuda")
    xl = torch.zeros_like(xh)
    out = {}
    for name, fn in (
            ("torch_add_", lambda: send.add_(1.0)),
            ("df_sum", lambda: comm.df_sum([r2, h1])),
            ("gather_partials", lambda: comm.gather_partials([r2, h1])),
            ("cat", lambda: torch.cat([r2[0].reshape(-1), h1[0], r2[1].reshape(-1),
                                       h1[1]])),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                buf, send, group=comm.group)),
            ("df_rank_sum", lambda: df.df_rank_sum(parts[:, :k], parts[:, k:])),
            ("matvec_df_sharded", lambda: sop.matvec_df(xh, xl)),
            ("matvec_df_unsharded", lambda: sop.op.matvec_df(xh, xl))):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        done = time.perf_counter() - t0
        out[name] = {"host_us": 1e6 * host / calls, "done_us": 1e6 * done / calls}
    return out


def phase_sharded_ext_p1(torch):
    """extended=True with sharding= on a one-rank NCCL group, each beside
    its unsharded solve in this call: (a) config 3 at full size (as
    `ext_conv`, restarts=1000, seed 3's v1) through the gathering wrapper
    (stencil5_df on the full grid), (b) the README matrix in float64 words
    at tol=1e-28 (as `ext_dd`) through the sharded DIA operator.  Q (and
    Q_lo), R (and R_lo), matvecs, restarts and host reads must equal the
    unsharded solve's bit for bit; config 3 must repeat ext_conv's 6,387
    matvecs and 213 restarts.  Each solve is driven with the counts at 0
    just before it and read just after: the sharded solve's three sums a
    Krylov step are folded by its gathered df_axpy and df_normalize
    launches (exact counts), df_rank_sum launches only for the sums outside
    a step, and every other launch is the unsharded solve's (7 a step).
    Then one Krylov step of config 3 in its gathered form and in its
    df_rank_sum form (a df_rank_sum launch a sum): the same bits, and the
    host time of each (`_ext_step_us`).  Returns the launches of df_rank_sum and of the
    gathered df_axpy and df_normalize over the two solves."""
    import numpy as np
    import torch.distributed as dist

    from arnoldimethod_torch.models.problems import laplacian_1d
    from arnoldimethod_torch.parallel import (
        basis_sharding,
        make_mesh,
        shard_operator,
    )

    conv, conv_kw = _config3(torch)
    ways = {
        "config3": (conv, dict(conv_kw, restarts=1000, extended=True)),
        "readme_dd": (laplacian_1d(100, dtype=torch.float64, device="cuda"),
                      dict(nev=10, which="SR", tol=1e-28, extended=True,
                           v1=np.random.default_rng(11).standard_normal(100))),
    }
    out, ok = {}, True
    launches = dict.fromkeys(("df_rank_sum", "df_axpy", "df_normalize"), 0)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        sharding = basis_sharding(make_mesh())
        for way, (op, kw) in ways.items():
            _ext_counts_zero()
            d0, h0, wall0 = _timed_solve(torch, op, **kw)
            base = _ext_counts()
            sop = shard_operator(op, sharding.mesh)
            _ext_counts_zero()
            d1, h1, wall1 = _timed_solve(torch, sop, sharding=sharding, **kw)
            counts = _ext_counts()
            pairs = [(d1.Q.to_local(), d0.Q)]
            same = np.array_equal(d1.R, d0.R) and np.array_equal(
                np.signbit(d1.R), np.signbit(d0.R))
            if hasattr(d0, "Q_lo"):
                pairs.append((d1.Q_lo.to_local(), d0.Q_lo))
                same = same and np.array_equal(d1.R_lo, d0.R_lo)
            same = (same and bitwise(pairs)
                    and (h1.mvproducts, h1.restarts, h1.host_syncs)
                    == (h0.mvproducts, h0.restarts, h0.host_syncs))
            steps = h1.mvproducts
            dfl, gath = counts["df_launches"], counts["gathered_launches"]
            launches["df_rank_sum"] += dfl["df_rank_sum"]
            for k, v in gath.items():
                launches[k] += v
            coll = counts["collectives"]
            # Three sums a Krylov step run (those a breakdown discards too),
            # three a breakdown's random row, and the start's one; one
            # all-reduce, the single-word start's norm.  A step's three are
            # folded by its df_axpy (two) and df_normalize (one) launches;
            # the others take a df_rank_sum launch each.  Every other
            # launch is the unsharded solve's: 7 a step.
            run = steps + counts["discarded_matvecs"]
            sums = 3 * (run + counts["rollbacks"]) + 1
            sums_ok = (coll["df_sum"]["calls"] == sums
                       and coll["all_reduce"]["calls"] == 1
                       and dfl["df_rank_sum"] == sums - 3 * run
                       and gath == {"df_axpy": 2 * run, "df_normalize": run})
            same_launches = (
                {k: v for k, v in dfl.items() if k != "df_rank_sum"}
                == {k: v for k, v in base["df_launches"].items()
                    if k != "df_rank_sum"}
                and base["df_launches"]["df_rank_sum"] == 0)
            counts_ok = (way != "config3"
                         or (h1.mvproducts, h1.restarts) == (6387, 213))
            ok = (ok and same and sums_ok and same_launches and counts_ok
                  and h1.converged)
            out[way] = dict(
                operator=type(sop).__name__, bitwise_q_r_counts=same,
                mvproducts=h1.mvproducts, restarts=h1.restarts,
                nconverged=h1.nconverged, host_syncs=h1.host_syncs,
                host_reads_per_step=h1.host_syncs / steps,
                collectives=coll,
                collectives_per_step=_per_step(coll, steps),
                df_launches=dfl, gathered_launches=gath,
                unsharded_df_launches=base["df_launches"],
                same_launches_as_unsharded=same_launches,
                df_launches_per_step={k: v / steps for k, v in dfl.items()},
                all_df_launches_per_step=sum(dfl.values()) / steps,
                unsharded_df_launches_per_step=sum(
                    base["df_launches"].values()) / steps,
                plain_df_calls_on_card=counts["plain_df_calls_on_card"],
                stencil_launches=counts["launches"]["stencil5"],
                wall_s=wall1, unsharded_wall_s=wall0,
                sharded_over_unsharded_wall=wall1 / wall0)
            del d0, d1
        sop = shard_operator(conv, sharding.mesh)
        comm_us = _ext_comm_us(torch, sop.comm, sop)
        step_us = _ext_step_us(torch, sop, sop.comm, conv_kw["v1"])
        ok = ok and step_us["bitwise"]
        # 3 restarts of the sharded config 3 under the profiler.
        _profile(torch, "sharded_ext_p1_profile", sop, "(anonymous namespace)",
                 "profile_sharded_ext.txt", label="df_kernels",
                 parts={"df_rank_sum": "rank_sum_kernel",
                        "stencil5_df": "stencil_kernel", "nccl": "nccl"},
                 restarts=3, sharding=sharding, extended=True, **conv_kw)
    finally:
        dist.destroy_process_group()
    check("sharded_ext_p1", ok, world_size=1, backend="nccl",
          q_type="DTensor Shard(0)", ways=out, launches=launches,
          comm_us=comm_us, step_us=step_us,
          prediction={"step_launches": 7, "df_rank_sum_launches": 1,
                      "host_us_saved_a_step": 3 * 34,
                      "source": "PERF.md §6"})
    return launches


def sharded_ext_rank(torch, rank, world, init, out_dir):
    """`--sharded-ext-rank RANK WORLD INIT OUT`: one rank of sharded_ext_p2
    on cuda:0 through gloo.  laplacian_1d(100) in float32 words at
    tol=1e-12 to convergence through the sharded DIA operator, on the card
    and then on the CPU from the same v1; config 3 for P2_SHORT restarts on
    the card with a sharded workspace; one Krylov step of config 3 both
    ways (`_ext_step_us`); the wide-band DIA (`_wide_dia_run`).  Each run
    driven with the counts at 0; writes OUT/rank<RANK>.json."""
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from arnoldimethod_torch import ArnoldiWorkspace
    from arnoldimethod_torch.models.problems import laplacian_1d
    from arnoldimethod_torch.parallel import (
        basis_sharding,
        make_mesh,
        row_comm,
        shard_operator,
    )

    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=600))
    result = {"rank": rank}
    try:
        sharding = basis_sharding(make_mesh())
        v1 = np.random.default_rng(11).standard_normal(100)
        runs = {}
        for dev in ("cuda", "cpu"):
            op = shard_operator(laplacian_1d(100, dtype=torch.float32,
                                             device=dev), sharding.mesh)
            dist.barrier()
            _ext_counts_zero()
            d, h, wall = _timed_solve(torch, op, sharding=sharding, nev=10,
                                      which="SR", tol=1e-12, extended=True,
                                      v1=v1)
            counts = _ext_counts()
            Q = row_comm(sharding, 100).gather_rows(d.Q.to_local()).cpu().numpy()
            runs[f"readme_{dev}"] = dict(
                operator=type(op).__name__, mvproducts=h.mvproducts,
                restarts=h.restarts, nconverged=h.nconverged,
                converged=h.converged, host_syncs=h.host_syncs, wall_s=wall,
                R=_digest(d.R), Q=_digest(Q),
                schur_residual=float(np.linalg.norm(
                    _lap1d_dense(100) @ Q - Q @ d.R)),
                collectives_per_step=_per_step(counts["collectives"],
                                               h.mvproducts),
                df_launches=counts["df_launches"],
                gathered_launches=counts["gathered_launches"])
            print(dev, runs[f"readme_{dev}"], flush=True)
        conv, conv_kw = _config3(torch)
        n = conv.shape[0]
        ws = ArnoldiWorkspace(n, conv_kw["maxdim"], dtype=torch.float32,
                              device="cuda", sharding=sharding)
        op = shard_operator(conv, sharding.mesh)
        dist.barrier()
        _ext_counts_zero()
        d, h, wall = _timed_solve(torch, op, sharding=sharding, workspace=ws,
                                  restarts=P2_SHORT, extended=True, **conv_kw)
        counts = _ext_counts()
        runs["config3"] = dict(
            operator=type(op).__name__, mvproducts=h.mvproducts,
            restarts=h.restarts, nconverged=h.nconverged,
            host_syncs=h.host_syncs, wall_s=wall, H=_digest(ws.H),
            R=_digest(d.R), collectives_per_step=_per_step(
                counts["collectives"], h.mvproducts),
            df_launches=counts["df_launches"],
            gathered_launches=counts["gathered_launches"],
            stencil_df_launches=counts["df_launches"]["stencil5_df"])
        print("config3", runs["config3"], flush=True)
        result["runs"] = runs
        dist.barrier()
        result["step_us"] = _ext_step_us(torch, op, op.comm, conv_kw["v1"],
                                         calls=60)
        print("step_us", result["step_us"], flush=True)
        dist.barrier()
        result["wide_dia"] = _wide_dia_run(torch, sharding, extended=True)
        print("wide_dia", result["wide_dia"], flush=True)
    finally:
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)


def phase_sharded_ext_p2(torch, timeout=300):
    """extended=True with sharding= on two processes sharing cuda:0 through
    gloo (`sharded_ext_rank`): laplacian_1d(100) in float32 words to
    convergence, residual below 1e-11 in host float64 and the same counts
    on the card as on the CPU at two ranks; config 3 for P2_SHORT
    restarts.  Both ranks must agree on every count, R and config 3's H.
    Then one Krylov step of config 3 in its gathered form and in its
    df_rank_sum form, the same bits on both ranks (`_ext_step_us`), and the
    DIA band wider than a rank's rows (F8) in float32 words: the unsharded
    solve's counts on both ranks.  Returns the launches on the card of
    df_rank_sum and of the gathered df_axpy and df_normalize, summed over
    the ranks."""
    results, wall = _two_ranks("sharded_ext_p2", "--sharded-ext-rank",
                               "sharded_ext_p2", timeout)
    keys = ("mvproducts", "restarts", "nconverged", "host_syncs", "R")
    r0, r1 = (r.get("runs", {}) for r in results)
    agree = bool(r0) and all(r0[run][k] == r1[run][k]
                             for run in r0 for k in keys)
    agree = agree and r0["config3"]["H"] == r1["config3"]["H"]
    card, cpu = r0["readme_cuda"], r0["readme_cpu"]
    ok = (agree and card["converged"] and card["schur_residual"] < 1e-11
          and (card["mvproducts"], card["restarts"])
          == (cpu["mvproducts"], cpu["restarts"])
          and r0["config3"]["restarts"] == P2_SHORT)
    main_runs = ("readme_cuda", "config3")
    launches = {"df_rank_sum": sum(
        r["runs"][run]["df_launches"]["df_rank_sum"]
        for r in results for run in main_runs)}
    for k in ("df_axpy", "df_normalize"):
        launches[k] = sum(r["runs"][run]["gathered_launches"][k]
                          for r in results for run in main_runs)
    steps = [r.get("step_us", {}) for r in results]
    steps_ok = all(st.get("bitwise") for st in steps) and len(
        {st.get("digest") for st in steps}) == 1
    wide = [r.get("wide_dia") for r in results]
    wide_ok = all(wide) and _wide_dia_ok(wide)
    check("sharded_ext_p2", ok and steps_ok and wide_ok, world_size=2,
          backend="gloo (CUDA tensors)",
          device="cuda:0 shared by both ranks", seconds=wall,
          ranks_agree=agree, runs=r0,
          walls_s_by_rank={run: [r["runs"][run]["wall_s"] for r in results]
                           for run in r0},
          restarts_cut_to={"config3": P2_SHORT}, wall_label=SHARDED_LABEL,
          launches=launches, step_us=steps, step_bitwise=steps_ok,
          wide_dia=dict(wide[0] or {}, ok=wide_ok))
    return launches


def device_only(torch, card):
    """--device: the roofline, the dense restart kernels and the device
    method's two solves alone."""
    phase_roofline(torch)
    phase_dense_restart_kernel(torch)
    phase_device_readme(torch)
    phase_device_main(torch)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import arnoldimethod_torch  # noqa: F401  (fails outside the repository)

    ranks = {"--sharded-rank": sharded_rank,
             "--sharded-ext-rank": sharded_ext_rank}
    if sys.argv[1:2] and sys.argv[1] in ranks:
        rank, world, init, out_dir = sys.argv[2:6]
        ranks[sys.argv[1]](torch, int(rank), int(world), init, out_dir)
        return
    if sys.argv[1:] == ["--comm-costs"]:
        comm_costs(torch)
        return
    card = phase_device(torch)
    phase_build()
    if sys.argv[1:] == ["--sharded"]:
        phase_sharded_p1(torch)
        phase_sharded_p2(torch)
        phase_sharded_ext_p1(torch)
        phase_sharded_ext_p2(torch)
        return
    if sys.argv[1:] == ["--device"]:
        device_only(torch, card)
        return
    if sys.argv[1:] == ["--dense-restart"]:
        phase_dense_restart_kernel(torch)
        return
    if sys.argv[1:] == ["--conv-starts"]:
        conv_starts(torch)
        return
    if sys.argv[1:] == ["--df-kernel"]:
        phase_df_kernel(torch)
        return
    if sys.argv[1:] == ["--extended"]:
        phase_df_kernel(torch)
        phase_ext_readme(torch)
        phase_ext_dd(torch)
        phase_ext_conv(torch)
        return
    if sys.argv[1:] == ["--project-sweep"]:
        project_sweep(torch)
        return
    if sys.argv[1:] == ["--df-sweep"]:
        df_sweep(torch)
        return
    if sys.argv[1:] == ["--axpy-sweep"]:
        axpy_sweep(torch)
        return
    kernels = phase_kernel(torch)
    phase_small(torch)
    phase_readme(torch)
    d, main_launches, main_wall = phase_main(torch)
    phase_eigen(torch, d)
    del d
    dgks_profile = phase_profile(torch)
    lowsync_launches = phase_lowsync_main(torch, main_wall, dgks_profile)

    import numpy as np

    from arnoldimethod_torch.models.operators import BsrOperator

    # The 65,536-row BSR matrix, built once from its block arrays: float32
    # (the kernel's operator) and the same values in float64 (plain).
    cols, data = bsr_pattern(512, 8, 128, np.float32)
    n = 512 * 128
    op32 = BsrOperator(cols, data, (n, n), device="cuda")
    op64 = BsrOperator(cols, data.astype(np.float64), (n, n),
                       use_pallas=False, device="cuda")
    del cols, data
    bsr_shape = phase_bsr_kernel(torch, op32, op64)
    phase_bsr_small(torch)
    bsr_launches = phase_bsr_main(torch, op32, op64)
    phase_sparse_auto(torch)
    _profile(torch, "bsr_profile", op32, "bsr", "profile_bsr.txt",
             v1=np.random.default_rng(1).standard_normal(n), nev=10,
             which="LM", tol=1e-6, restarts=3)
    del op32, op64
    cheb_shape = phase_cheb_kernel(torch)
    cheb_launches = phase_e2e10m(torch)
    phase_shiftinv(torch)
    phase_conv1m(torch)
    phase_default_device(torch)
    phase_complex_bsr(torch)
    phase_complexsc(torch)
    phase_complexscsparse(torch)
    df_shapes = phase_df_kernel(torch)
    phase_ext_readme(torch)
    phase_ext_dd(torch)
    df_launches, project_forms, axpy_forms = phase_ext_conv(torch)
    # method="device" last: the earlier phases run as they did before it.
    phase_roofline(torch)
    restart_lines, _, restart_captured = phase_dense_restart_kernel(torch)
    phase_device_readme(torch)
    device_launches = phase_device_main(torch)
    # The row-sharded solver last: it starts process groups.
    p1_launches = phase_sharded_p1(torch)
    p2_launches = phase_sharded_p2(torch)
    ext_launches = {"sharded_ext_p1": phase_sharded_ext_p1(torch),
                    "sharded_ext_p2": phase_sharded_ext_p2(torch)}

    def ext_by_phase(kernel):
        return {phase: got[kernel] for phase, got in ext_launches.items()}

    by_phase = {k: {"device_main": device_launches[k],
                    "sharded_p1": p1_launches[k],
                    "sharded_p2": p2_launches[k]}
                for k in ("stencil5", "dense_restart", "dense_finish")}
    launches = (main_launches + lowsync_launches + device_launches["stencil5"]
                + p1_launches["stencil5"] + p2_launches["stencil5"])

    def entry(name, source, replaces, launches, shape, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        # A bytes bound restated at the copy rate measured by `roofline`.
        at_copy = (shape["bound_ms"] * PEAK_BYTES_S / COPY["bytes_s"]
                   if shape["bound_by"] == "bytes" else shape["bound_ms"])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **extra, "launches": launches,
                **{k: shape[k] for k in keys},
                "bound_ms_at_copy_rate": at_copy}

    dr80, dr200 = restart_lines[(80, torch.float32)], restart_lines[(200, torch.float32)]
    finish80 = {k: dr80[f"finish_{k}"] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}
    finish80.update(max_abs_err=dr80["max_abs_err"], library_ms=None)

    xla = "; an XLA loop, not a Pallas kernel"
    df_src = "arnoldimethod_torch/csrc/df.cu"
    print(card, flush=True)
    emit({"kernels": [
        entry("stencil5", "arnoldimethod_torch/csrc/stencil5.cu",
              "arnoldimethod_tpu/ops/stencil_pallas.py:240", launches,
              kernels[0],
              also_replaces="arnoldimethod_tpu/ops/stencil_pallas.py:157",
              launches_by_phase={"main": main_launches,
                                 "lowsync_main": lowsync_launches,
                                 **by_phase["stencil5"]}),
        entry("bsr", "arnoldimethod_torch/csrc/bsr.cu",
              "arnoldimethod_tpu/ops/bsr_pallas.py:138", bsr_launches,
              bsr_shape),
        entry("stencil5_cheb", "arnoldimethod_torch/csrc/stencil5.cu",
              "arnoldimethod_tpu/transforms.py:199 (XLA-fused recurrence; "
              "not a Pallas kernel)", cheb_launches, cheb_shape),
        entry("df_project", df_src,
              "arnoldimethod_tpu/ops/df32.py:201 df_project_coeffs_df with "
              "df_sum at :147" + xla, df_launches["df_project"],
              df_shapes["df_project"],
              one_row_launches=project_forms["one_row"],
              full_launches=project_forms["full"],
              **{k: df_shapes["df_project"][k] for k in (
                  "one_row_ms", "one_row_bound_ms")}),
        # The main path launches the fused form only: its numbers lead, the
        # plain form's stand beside them.
        entry("df_axpy", df_src,
              "arnoldimethod_tpu/ops/df32.py:209 df_axpy_update_df" + xla,
              df_launches["df_axpy"], df_shapes["df_axpy_norm"],
              also_replaces="arnoldimethod_tpu/ops/df32.py:238 df_norm's sum",
              form="fused norm", plain_launches=axpy_forms["plain"],
              norm_launches=axpy_forms["norm"],
              **{"plain_form_" + k: df_shapes["df_axpy"][k] for k in (
                  "ms", "plain_ms", "bound_ms")}),
        entry("df_normalize", df_src,
              "arnoldimethod_tpu/ops/df_expansion.py:71 _df_normalize "
              "(df_mul by 1 / ||w||)" + xla, df_launches["df_normalize"],
              df_shapes["df_normalize"],
              also_replaces="arnoldimethod_tpu/ops/df_expansion.py:48 "
                            "_df_dgks's lax.cond and :109 the breakdown test",
              form="step (second pass taken)"),
        entry("df_basis_change", df_src,
              "arnoldimethod_tpu/ops/df_expansion.py:150 "
              "_df_basis_change_impl" + xla, df_launches["df_basis_change"],
              df_shapes["df_basis_change"]),
        entry("stencil5_df", df_src,
              "arnoldimethod_tpu/models/operators.py:395 "
              "Stencil5Operator.matvec_df" + xla, df_launches["stencil5_df"],
              df_shapes["stencil5_df"]),
        # The sharded extended path's sums over the ranks: a Krylov step's
        # are folded by the gathered df_axpy and df_normalize, the others by
        # df_rank_sum; launches are sharded_ext_p1's and sharded_ext_p2's
        # (both ranks).
        entry("df_rank_sum", df_src,
              "arnoldimethod_tpu/ops/df32.py:147 df_sum's tree, which GSPMD "
              "partitions into collectives on a sharded V" + xla,
              sum(ext_by_phase("df_rank_sum").values()),
              df_shapes["df_rank_sum"],
              launches_by_phase=ext_by_phase("df_rank_sum"),
              **{k: df_shapes["df_rank_sum"][k] for k in (
                  "case", "one_rank_ms", "one_rank_bound_ms",
                  "one_rank_plain_ms")}),
        *(entry(name, df_src,
                "arnoldimethod_tpu/ops/df32.py:147 df_sum's tree on a sharded "
                "V (GSPMD's collectives), folded into " + form + xla,
                sum(ext_by_phase(kernel).values()), df_shapes[name],
                launches_by_phase=ext_by_phase(kernel),
                **{k: df_shapes[name][k] for k in (
                    "case", "one_rank_ms", "one_rank_bound_ms",
                    "one_rank_plain_ms", "replaced_ms",
                    "one_rank_replaced_ms")})
          for name, kernel, form in (
              ("df_axpy_gathered", "df_axpy",
               "df_axpy's fused form (ops/df32.py:209)"),
              ("df_normalize_gathered", "df_normalize",
               "df_normalize's step form (ops/df_expansion.py:71)"))),
        # The numbers of the m = 80 float32 case (device_main's m).
        entry("dense_restart", "arnoldimethod_torch/csrc/dense_restart.cu",
              "arnoldimethod_tpu/fused.py:109-202 (the lax.while_loop body "
              "over arnoldimethod_tpu/dense/device.py)" + xla,
              sum(by_phase["dense_restart"].values()), dr80,
              case="arnoldi_m80 float32",
              launches_by_phase=by_phase["dense_restart"],
              one_sm_bound_ms=dr80["one_sm_bound_ms"],
              host_core_ms=dr80["host_core_ms"],
              storage=dr80["storage"], steps=dr80["steps"],
              m200={k: dr200[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "one_sm_bound_ms", "host_core_ms",
                                          "storage")},
              captured_restart3={k: restart_captured[k] for k in (
                  "ms", "plain_ms", "bound_ms", "host_core_ms", "bitwise")}),
        entry("dense_finish", "arnoldimethod_torch/csrc/dense_restart.cu",
              "arnoldimethod_tpu/fused.py:221 _fused_finish" + xla,
              sum(by_phase["dense_finish"].values()), finish80,
              case="arnoldi_m80 float32",
              launches_by_phase=by_phase["dense_finish"],
              one_sm_bound_ms=dr80["finish_one_sm_bound_ms"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
