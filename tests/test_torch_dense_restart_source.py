"""The restart and finish kernels of arnoldimethod_torch/csrc/
dense_restart.cu run on the CPU: the source compiled with g++ against
tests/cuda_host_shim.h (a host thread per CUDA thread, barriers, warp
shuffles), built with -ffp-contract=off as the card's build uses
--fmad=false.  Every output is held bit for bit to the plain version
(arnoldimethod_torch/dense/device.py): H, Q, Qbig, the state and the
integer details (nlock, k, purge, effective nev, the sorted order, the
groups), on Arnoldi factorizations and on the inputs of every restart of
whole solves, which then run through the kernels and must equal the plain
solves exactly.  A copy whose hypot rounds differently must fail.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import arnoldimethod_torch as tam
from arnoldimethod_torch import _device, fused
from arnoldimethod_torch.dense import device as dd
from arnoldimethod_torch.models import problems as tp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CU = REPO / "arnoldimethod_torch" / "csrc" / "dense_restart.cu"
SHIM = Path(__file__).resolve().parent / "cuda_host_shim.h"


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def host_source(cu):
    """The .cu text for the host shim: shared memory as statics, launches
    as emu_launch."""
    s = cu.replace("__shared__", "static")
    s = re.sub(r"(\b\w+_kernel<[^<>;]*>)\s*<<<(.*?)>>>\s*\((.*?)\);",
               lambda m: "emu_launch(" + ", ".join(m.group(2).split(",")[:2])
               + ", [&] { " + m.group(1) + "(" + m.group(3) + "); });",
               s, flags=re.S)
    assert "<<<" not in s
    return s.replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')


def _host_build(directory, cu):
    src = directory / "dense_restart_host.cpp"
    src.write_text(host_source(cu))
    so = directory / "libdense_restart_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-Wno-unknown-pragmas", "-o",
                    str(so), str(src)], check=True, capture_output=True,
                   timeout=300)
    return dd.bind(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of dense_restart.cu needs g++")
    return _host_build(tmp_path_factory.mktemp("dr_host"), CU.read_text())


# hypot by another formula, equal up to rounding: the comparison must see
# single roundings.
STEP = "return hi * vsqrt(T(1) + q * q);"
MUTANT = "return vsqrt(hi * hi + lo * lo);"


@pytest.fixture(scope="module")
def mutant(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of dense_restart.cu needs g++")
    cu = CU.read_text()
    assert cu.count(STEP) == 1
    return _host_build(tmp_path_factory.mktemp("dr_mutant"),
                       cu.replace(STEP, MUTANT))


def _scratch(lib, H):
    m = H.shape[1]
    return (torch.empty(lib.dense_restart_work_len(m), dtype=H.dtype),
            torch.empty(lib.dense_restart_iwork_len(m), dtype=torch.int32))


def k_restart(lib, H, Qbig, state, flags, nev, mindim, tol, restarts, which,
              info, threads=64):
    m = H.shape[1]
    Q = torch.empty((m, m), dtype=H.dtype)
    work, iwork = _scratch(lib, H)
    fn = lib.dense_restart_f32 if H.dtype == torch.float32 else lib.dense_restart_f64
    assert fn(H.data_ptr(), Q.data_ptr(), Qbig.data_ptr(), state.data_ptr(),
              flags.data_ptr(), info.data_ptr(), work.data_ptr(),
              iwork.data_ptr(), m, nev, mindim, tol, restarts,
              dd.ORDER_CODES[which], 100 * m, threads, None) == 0
    return Q


def k_finish(lib, H, Qbig, lam, state, which, threads=64):
    m = H.shape[1]
    Q = torch.empty((m, m), dtype=H.dtype)
    work, iwork = _scratch(lib, H)
    fn = lib.dense_finish_f32 if H.dtype == torch.float32 else lib.dense_finish_f64
    assert fn(H.data_ptr(), Q.data_ptr(), Qbig.data_ptr(), lam.data_ptr(),
              state.data_ptr(), work.data_ptr(), iwork.data_ptr(), m,
              dd.ORDER_CODES[which], threads, None) == 0
    return Q


def _arnoldi(m, seed, dtype):
    """H of an m-step Arnoldi factorization of a Gaussian matrix, with
    complex Ritz pairs."""
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
    return torch.tensor(H, dtype=dtype)


def _both(lib, H0, state0, flags, kw, threads=64):
    out = []
    for use_kernel in (False, True):
        m = H0.shape[1]
        H, state = H0.clone(), state0.clone()
        Qbig = torch.full((m + 1, m + 1), -7.0, dtype=H0.dtype)
        info = torch.zeros(4 + 2 * m, dtype=torch.int32)
        if use_kernel:
            Q = k_restart(lib, H, Qbig, state, flags, info=info,
                          threads=threads, **kw)
        else:
            Q = dd.restart_plain(H, Qbig, state, flags, info=info, **kw)
        out.append((H, Q, Qbig, state, info))
    return out


def _equal(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,which,threads", [(12, "LM", 32), (20, "SR", 64),
                                             (33, "LR", 64)])
def test_restart_kernel_is_the_plain_version(lib, dtype, m, which, threads):
    H0 = _arnoldi(m, m, dtype)
    kw = dict(nev=4, mindim=m // 2, tol=1e-3, restarts=50, which=which)
    plain, kern = _both(lib, H0, dd.new_state(0, m, 50),
                        torch.zeros(m, dtype=dtype), kw, threads)
    _equal(plain, kern)
    state = kern[3].tolist()
    assert state[dd.STATE["rollback"]] == -1 and state[dd.STATE["it"]] == 1
    info = kern[4].tolist()
    assert sorted(info[4:4 + m]) == list(range(m))
    assert set(info[4 + m:]) <= {1, 2, 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restart_kernel_rolls_back(lib, dtype):
    """A set breakdown flag: the rollback slot takes the first flagged
    step and nothing else changes."""
    m = 12
    H0 = _arnoldi(m, 3, dtype)
    flags = torch.zeros(m, dtype=dtype)
    flags[[7, 9]] = 1
    kw = dict(nev=4, mindim=6, tol=1e-3, restarts=50, which="LM")
    plain, kern = _both(lib, H0, dd.new_state(0, m, 50), flags, kw)
    _equal(plain[::2], kern[::2])
    assert torch.equal(kern[0], H0)
    assert kern[3].tolist()[dd.STATE["rollback"]] == 7


def _captured_solve(monkeypatch, lib, run, use_kernel):
    """Run `run` with the fused loop's dense phases either plain or through
    the host-built kernels; return its result and each restart's input."""
    seen = []
    plain_restart, plain_finish = fused.restart, fused.finish

    def restart(H, Qbig, state, flags, **kw):
        seen.append((H.clone(), state.clone(), flags.clone(), kw))
        if not use_kernel:
            return plain_restart(H, Qbig, state, flags, **kw)
        m = H.shape[1]
        kw = dict(kw)
        maxiter = kw.pop("maxiter") or 100 * m
        assert maxiter == 100 * m
        return k_restart(lib, H, Qbig, state, flags,
                         info=torch.zeros(4 + 2 * m, dtype=torch.int32),
                         **{k: v for k, v in kw.items() if k != "info"})

    def finish(H, Qbig, lam, state, which):
        if not use_kernel:
            return plain_finish(H, Qbig, lam, state, which)
        return k_finish(lib, H, Qbig, lam, state, which)

    monkeypatch.setattr(fused, "restart", restart)
    monkeypatch.setattr(fused, "finish", finish)
    try:
        return run(), seen
    finally:
        monkeypatch.setattr(fused, "restart", plain_restart)
        monkeypatch.setattr(fused, "finish", plain_finish)


def _readme32():
    return tam.partial_schur(tp.laplacian_1d(100, dtype=np.float32),
                             v1=np.random.default_rng(0).standard_normal(100),
                             nev=10, which="SR", tol=1e-6, method="device")


def _purge():
    n = 100
    A = np.diag(np.concatenate([[11.0, 10.999, 10.0, 9.5, 9.0],
                                np.linspace(1.0, 8.0, n - 5)]))
    v1 = np.ones(n)
    v1[0] = v1[1] = 1e-12
    return tam.partial_schur(A, v1=v1, nev=3, which="LM", tol=1e-8,
                             method="device")


def _pairs():
    A = np.random.default_rng(3).standard_normal((80, 80))
    return tam.partial_schur(A, v1=np.random.default_rng(5).standard_normal(80),
                             nev=6, which="LM", tol=1e-9, method="device")


def _rank3():
    rng = np.random.default_rng(1)
    W = rng.standard_normal((10, 3))
    return tam.partial_schur(W @ W.T, v1=np.ones(10), nev=5, mindim=5,
                             maxdim=7, tol=np.finfo(float).eps,
                             method="device")


@pytest.mark.parametrize("run", [_readme32, _purge, _pairs, _rank3],
                         ids=["readme32", "purge", "pairs", "rank3"])
def test_solves_through_the_kernels_are_the_plain_ones(monkeypatch, lib, run):
    (d0, h0), seen = _captured_solve(monkeypatch, lib, run, False)
    (d1, h1), _ = _captured_solve(monkeypatch, lib, run, True)
    assert (h1.mvproducts, h1.restarts, h1.purges, h1.nconverged) == (
        h0.mvproducts, h0.restarts, h0.purges, h0.nconverged)
    assert np.array_equal(d0.R, d1.R)
    assert np.array_equal(d0.eigenvalues, d1.eigenvalues)
    assert torch.equal(d0.Q, d1.Q)
    # Every restart's input on its own, with the details.
    for H0, state0, flags, kw in seen[1::3]:
        kw = {k: v for k, v in kw.items() if k not in ("maxiter", "info")}
        plain, kern = _both(lib, H0, state0, flags, kw)
        _equal(plain, kern)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which,count", [("LM", 9), ("SR", 5), ("LR", 1)])
def test_finish_kernel_is_the_plain_version(lib, dtype, which, count):
    m = 12
    H0 = _arnoldi(m, 8, dtype)
    Q = torch.eye(m, dtype=dtype)
    dd.local_schur(H0, Q, 0, m)
    state = dd.new_state(count, m, 5)
    out = []
    for use_kernel in (False, True):
        H = H0.clone()
        Qbig = torch.empty((m + 1, m + 1), dtype=dtype)
        lam = torch.empty((2, m), dtype=dtype)
        if use_kernel:
            Qf = k_finish(lib, H, Qbig, lam, state, which)
        else:
            Qf = dd.finish_plain(H, Qbig, lam, count, which)
        out.append((H, Qf, Qbig, lam))
    _equal(*out)


def test_mutant_fails(mutant):
    """The same comparison on a copy with one operation changed."""
    H0 = _arnoldi(20, 20, torch.float64)
    kw = dict(nev=4, mindim=10, tol=1e-3, restarts=50, which="LM")
    plain, kern = _both(mutant, H0, dd.new_state(0, 20, 50),
                        torch.zeros(20, dtype=torch.float64), kw)
    assert not all(torch.equal(a, b) for a, b in zip(plain, kern))
