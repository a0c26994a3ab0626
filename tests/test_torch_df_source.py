"""The CUDA source of the double-word kernels (arnoldimethod_torch/csrc/
df.cu) run on the CPU: compiled with g++ against tests/cuda_host_shim.h,
which emulates the few CUDA features they use (a thread per CUDA thread,
blocks in turn, barriers, shared memory, cp.async, atomics, warp
shuffles), and held bit for bit to their plain PyTorch versions: the basis
change and the stencil under every tile and every number of points a
thread, into new tensors and (the basis change) in place; df_normalize
in both forms and every decision of its step form;
df_axpy, plain and with its fused norm, under several launch plans (every
fold, short runs and runs of a block, one block and many, the norm's last
block with levels in device memory); df_project at its plan; df_rank_sum
(the sharded solve's sum over the ranks) at 1 to 256 ranks, with and
without acc.  A copy of the source with one operand swapped must fail, in
df_axpy and in df_rank_sum.

This checks the kernels' indexing, staging and order of operations where
there is no card; only chip_smoke.py shows that nvcc builds them and that
they run so on an H100.  Sizes are small: every CUDA thread is a host
thread here.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from arnoldimethod_torch import _device
from arnoldimethod_torch.ops import df, df32
from arnoldimethod_torch.ops.df32 import ETA

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SHIM = Path(__file__).resolve().parent / "cuda_host_shim.h"


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _top_level_args(text):
    """Split a launch configuration at its top-level commas."""
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
            continue
        depth += ch in "(<"
        depth -= ch in ")>"
        cur += ch
    return out + [cur]


def host_source(cu):
    """df.cu rewritten for the host shim: shared memory as statics (the
    dynamic stage as the shim's buffer), cp.async as emu_copy, launches as
    emu_launch."""
    s = cu.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                   "unsigned char* const smem_raw = ::emu_dynamic_shared;")
    s = s.replace("__shared__", "static")
    s = re.sub(r'asm volatile\("cp\.async\.cg[^;]*?;\\n"[^;]*;',
               "emu_copy(dst, src, 16, src_bytes);(void)d;", s, flags=re.S)
    s = re.sub(r'asm volatile\("cp\.async\.ca[^;]*?;\\n"[^;]*;',
               "emu_copy(dst, src, N, src_bytes);(void)d;", s, flags=re.S)
    s = re.sub(r'asm volatile\("cp\.async\.(commit|wait)[^;]*;\\n"[^;]*;', "",
               s, flags=re.S)
    assert "asm volatile" not in s
    s = re.sub(r"(\b\w+_kernel<[^<>;]*>)\s*<<<(.*?)>>>\s*\((.*?)\);",
               lambda m: "emu_launch(" + ", ".join(_top_level_args(m.group(2))[:2])
               + ", [&] { " + m.group(1) + "(" + m.group(3) + "); });",
               s, flags=re.S)
    assert "<<<" not in s
    return s.replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')


def _host_build(directory, cu):
    """df.cu's text `cu` built for the host shim into `directory`."""
    src = directory / "df_host.cpp"
    src.write_text(host_source(cu))
    so = directory / "libdf_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-Wno-unknown-pragmas", "-o",
                    str(so), str(src)], check=True, capture_output=True,
                   timeout=300)
    out = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int64
    sigs = {"df_basis_change": [p, p, p, p, i, i, i, i, i, i, p, p, p],
            "stencil5_df": [p, p, p, p, i, i, i, p, p],
            "df_axpy": [p, p, p, p, p, p, *[i] * 12, p, p, p, i, p, i, p, p,
                        p, p],
            "df_project": [p, p, i, p, p, *[i] * 8, p, i, p, i, p, p, p, p,
                           p],
            "df_normalize": [p] * 10 + [i, p, p, p, p, i, p, p, i, i, p, p,
                                        p, i, i, p],
            "df_rank_sum": [p, p, i, i, i, p, p, p, p, p]}
    for name, args in sigs.items():
        for word in ("_f32", "_f64"):
            f = getattr(out, name + word)
            f.argtypes = args
            f.restype = ctypes.c_int
    return out


CU = REPO / "arnoldimethod_torch" / "csrc" / "df.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of df.cu needs g++")
    return _host_build(tmp_path_factory.mktemp("df_host"), CU.read_text())


# One operand swapped in df_axpy's step: the hi and lo words of the term
# subtracted.
AXPY_STEP = "df_add(ah, al, -th, -tl, ah, al);"
MUTANT = "df_add(ah, al, -tl, -th, ah, al);"


# One operand swapped in df_rank_sum's shuffle level: the hi and lo words
# of the right operand.  Both mutations go into one build; each touches
# only its own kernel.
RANK_STEP = "df_add(vh, vl, uh, ul, vh, vl);"
RANK_MUTANT = "df_add(vh, vl, ul, uh, vh, vl);"


@pytest.fixture(scope="module")
def mutant(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of df.cu needs g++")
    cu = CU.read_text()
    assert cu.count(AXPY_STEP) == 1 and cu.count(RANK_STEP) == 1
    return _host_build(tmp_path_factory.mktemp("df_mutant"),
                       cu.replace(AXPY_STEP, MUTANT)
                       .replace(RANK_STEP, RANK_MUTANT))


INTS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(INTS[a.dtype]),
                                              b.view(INTS[b.dtype]))


def _pair(rng, dtype, *shape):
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
    return (torch.from_numpy(rng.standard_normal(shape)).to(dtype),
            torch.from_numpy(rng.standard_normal(shape) * lo).to(dtype))


def _word(dtype):
    return "_f32" if dtype == torch.float32 else "_f64"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m1,n,rows", [(61, 130, 61), (61, 97, 31),
                                       (61, 258, 46), (9, 37, 1)])
def test_basis_change_source_is_bitwise(lib, dtype, m1, n, rows):
    """Every tile of the word, a ragged last column tile (n % 4 != 0 takes
    the word-by-word copies), into new tensors and into V itself."""
    rng = np.random.default_rng(m1 + n + rows)
    Vh, Vl = _pair(rng, dtype, m1, n)
    Qh, Ql = _pair(rng, dtype, m1, m1)
    want = df.df_basis_change_plain(Vh, Vl, Qh, Ql, rows)
    fn = getattr(lib, "df_basis_change" + _word(dtype))
    for tile in df._BASIS_TILES[Vh.element_size()]:
        plan = df.basis_plan(m1, n, rows, Vh.element_size(), tile)
        oh = torch.full((rows, n), 7.0, dtype=dtype)
        ol = torch.full_like(oh, 7.0)
        assert fn(Vh.data_ptr(), Vl.data_ptr(), Qh.data_ptr(), Ql.data_ptr(),
                  m1, n, rows, plan.R, plan.C, plan.W, oh.data_ptr(),
                  ol.data_ptr(), None) == 0
        assert _bitwise(oh, want[0]) and _bitwise(ol, want[1]), tile
        assert plan.in_place
        Wh, Wl = Vh.clone(), Vl.clone()
        assert fn(Wh.data_ptr(), Wl.data_ptr(), Qh.data_ptr(), Ql.data_ptr(),
                  m1, n, rows, plan.R, plan.C, plan.W, Wh.data_ptr(),
                  Wl.data_ptr(), None) == 0
        assert _bitwise(Wh[:rows], want[0]) and _bitwise(Wl[:rows], want[1])
        assert _bitwise(Wh[rows:], Vh[rows:]) and _bitwise(Wl[rows:], Vl[rows:])


def test_basis_change_source_refuses_bad_plans(lib):
    V = torch.zeros(4, 8)
    Q = torch.zeros(4, 4)
    fn = lib.df_basis_change_f32
    for rows, R, C, W in ((0, 8, 2, 1), (5, 8, 2, 1), (4, 3, 2, 1),
                          (4, 8, 2, 9)):
        assert fn(V.data_ptr(), V.data_ptr(), Q.data_ptr(), Q.data_ptr(), 4,
                  8, rows, R, C, W, V.data_ptr(), V.data_ptr(), None) != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", [(25, 40), (9, 3), (33, 70)])
def test_stencil_source_is_bitwise(lib, dtype, grid):
    """One, two and four points a thread, ragged tiles at the grid's
    edges."""
    rng = np.random.default_rng(grid[0] * grid[1])
    ny, nx = grid
    xh, xl = _pair(rng, dtype, ny * nx)
    coeffs = (4.3, -1.2, -0.8, -1.0, -1.1)
    want = df.stencil5_df_plain(xh, xl, coeffs, grid)
    words = (ctypes.c_double * 15)(*df.coefficient_words(coeffs, dtype))
    fn = getattr(lib, "stencil5_df" + _word(dtype))
    for P in (1, 2, 4):
        yh, yl = torch.full_like(xh, 7.0), torch.full_like(xl, 7.0)
        assert fn(xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yl.data_ptr(),
                  ny, nx, P, words, None) == 0
        assert _bitwise(yh, want[0]) and _bitwise(yl, want[1]), P
    yh = torch.empty_like(xh)
    assert fn(xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yh.data_ptr(), ny,
              nx, 3, words, None) != 0


def _axpy_plans(n, rows, item, norm):
    """axpy_plan's launch and hand plans: few threads and many blocks (the
    norm's last block halving partials in device memory first, then
    folding 2, 4 or 8 a thread in registers), runs of a whole block, every
    fold, and one block."""
    N = 1 << max(0, n - 1).bit_length()
    run = min(32 // item, 32)

    def plan(T, C, L, U, stage):
        G = N // (T << L)
        return df.AxpyPlan(T, min(C, T), G, L, U, min(stage, G * min(C, T)))

    one = min(256, N // 2)
    return [df.axpy_plan(n, rows, item, norm),
            plan(32, run, 1, 2, 4),
            plan(64, 64, 2, 4, 64),
            plan(32, run, 0, 16, 1024),
            plan(32, 32, 0, 4, 1024),
            plan(64, run, 3, 1, 64),
            plan(one, run, (N // one).bit_length() - 1,
                 min(U for L, U in df._AXPY_SHAPES
                     if L == (N // one).bit_length() - 1), 1024)]


def _axpy_host(fn, plan, w, h, V, rows, norm):
    """One launch of the host-built df_axpy; ((outh, outl), sum or None)."""
    (wh, wl), (hh, hl), (Vh, Vl) = w, h, V
    outh, outl = torch.full_like(wh, 7.0), torch.full_like(wl, 7.0)
    part = torch.full((2 * plan.M,), 7.0, dtype=wh.dtype)
    arrivals = torch.zeros(1, dtype=torch.int32)
    s = torch.full((2,), 7.0, dtype=wh.dtype)
    err = fn(wh.data_ptr(), wl.data_ptr(), hh.data_ptr(), hl.data_ptr(),
             Vh.data_ptr(), Vl.data_ptr(), wh.shape[0], rows, plan.T, plan.C,
             plan.G, plan.L, plan.U, plan.stage, 0, 0, 0, 0, None, None,
             part.data_ptr(), part.numel(),
             arrivals.data_ptr(), 1, outh.data_ptr(), outl.data_ptr(),
             s.data_ptr() if norm else None, None)
    assert err == 0, plan
    assert int(arrivals[0]) == 0  # the last block leaves the counter zero
    return (outh, outl), ((s[0], s[1]) if norm else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,rows", [(1000, 61), (997, 31), (1000, 0),
                                    (100, 7)])
@pytest.mark.parametrize("norm", [False, True])
def test_axpy_source_is_bitwise(lib, dtype, n, rows, norm):
    """df_axpy's source under each plan: every fold, short runs and runs of
    a block, one block and many, ragged n; with the fused norm, its sum
    too."""
    rng = np.random.default_rng(n + rows)
    m1 = max(rows, 1)
    w, h, V = (_pair(rng, dtype, n), _pair(rng, dtype, m1),
               _pair(rng, dtype, m1, n))
    want = df.df_axpy_plain(*w, *h, *V, rows, norm)
    wout, wsum = want if norm else (want, None)
    fn = getattr(lib, "df_axpy" + _word(dtype))
    item = torch.finfo(dtype).bits // 8
    plans = _axpy_plans(n, rows, item, norm)
    assert any(p.G > 1 and p.M > p.stage for p in plans)
    for plan in plans:
        if plan.G < 1 or plan.smem(rows, item, norm) > 48 * 1024:
            continue
        out, got = _axpy_host(fn, plan, w, h, V, rows, norm)
        assert _bitwise(out[0], wout[0]) and _bitwise(out[1], wout[1]), plan
        if norm:
            assert all(_bitwise(a.reshape(1), b.reshape(1))
                       for a, b in zip(got, wsum)), plan


def test_axpy_source_refuses_bad_plans(lib):
    """A valid launch of 64 elements, then each field made invalid."""
    w = torch.zeros(64)
    fn = lib.df_axpy_f32
    good = dict(T=64, C=8, G=1, L=0, U=8, rows=1)

    def launch(T, C, G, L, U, rows):
        return fn(*[w.data_ptr()] * 6, 64, rows, T, C, G, L, U, 8, 0, 0, 0,
                  0, None, None, None, 0, None, 0, w.data_ptr(), w.data_ptr(),
                  None, None)

    assert launch(**good) == 0
    for bad in ({"G": 2}, {"L": 1}, {"T": 512, "L": -3}, {"C": 3},
                {"U": 3}, {"L": 4, "T": 4}, {"rows": 257}):
        assert launch(**{**good, **bad}) != 0, bad


def test_axpy_source_mutation_fails(mutant):
    """The swapped operand changes the result: the comparison above sees
    it."""
    rng = np.random.default_rng(3)
    w, h, V = (_pair(rng, torch.float32, 1000), _pair(rng, torch.float32, 7),
               _pair(rng, torch.float32, 7, 1000))
    want = df.df_axpy_plain(*w, *h, *V, 7)
    plan = df.axpy_plan(1000, 7, 4)
    out, _ = _axpy_host(mutant.df_axpy_f32, plan, w, h, V, 7, False)
    assert not (_bitwise(out[0], want[0]) and _bitwise(out[1], want[1]))


# df_normalize's cases: the sums (hi words; lo a fraction of them) of
# r2, s1 and s2, or None for the one-sum form (s1 alone), and what the
# step decides (second pass, breakdown).
NORMALIZE_CASES = {
    "one_sum": ((None, 0.81, None), None),
    "first": ((3.0, 2.25, 1.44), (False, False)),
    "second": ((9.0, 2.25, 1.44), (True, False)),
    "second_breakdown": ((9.0, 2.25, 0.25), (True, True)),
    "zero": ((0.0, 0.0, 0.0), (False, True)),
}


def _sum(v, dtype):
    lo = 2.0 ** (-27 if dtype == torch.float32 else -56)
    return (torch.tensor(v, dtype=dtype), torch.tensor(v * lo, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 7, 1000, 1003])
@pytest.mark.parametrize("case", list(NORMALIZE_CASES))
def test_normalize_source_is_bitwise(lib, dtype, n, case):
    """Every decision of the step form (second pass taken and not,
    breakdown and not, an exactly zero sum: df_sqrt(0) = (0, 0), no NaN)
    and the one-sum form; 16 bytes of each word a step where every
    operand is aligned (the rest one by one), and one element a step where
    w starts one word off.  The row, H's column j and flags[j] are the
    plain version's bit for bit; the other columns and flags untouched."""
    rng = np.random.default_rng(n)
    (r2, s1, s2), decides = NORMALIZE_CASES[case]
    w1h, w1l = _pair(rng, dtype, n + 1)
    w2h, w2l = _pair(rng, dtype, n + 1)
    if case == "zero":
        for t in (w1h, w1l, w2h, w2l):
            t.zero_()
    m1, m, j = 7, 6, 3
    h1, c = _pair(rng, dtype, m1), _pair(rng, dtype, m1)
    fn = getattr(lib, "df_normalize" + _word(dtype))
    for at in (slice(0, n), slice(1, n + 1)):
        w1, w2 = (w1h[at], w1l[at]), (w2h[at], w2l[at])
        outs, Hs, flags = [], [], []
        for kernel in (True, False):
            out = (torch.full((n,), 7.0, dtype=dtype),
                   torch.full((n,), 7.0, dtype=dtype))
            H = (torch.full((m1, m), 7.0, dtype=dtype),
                 torch.full((m1, m), 7.0, dtype=dtype))
            flag = torch.full((m,), 7.0, dtype=dtype)
            step = None if decides is None else df.DgksStep(
                _sum(r2, dtype), w2, _sum(s2, dtype), h1, c, H, j, flag)
            if kernel:
                assert fn(*df._normalize_args(w1, _sum(s1, dtype), out, step),
                          None) == 0
            else:
                df.df_normalize_plain(w1, _sum(s1, dtype), out, step)
            outs.append(out)
            Hs.append(H)
            flags.append(flag)
        assert all(_bitwise(a, b) for a, b in zip(
            (*outs[0], *Hs[0], flags[0]), (*outs[1], *Hs[1], flags[1])))
        if decides is None:
            assert (Hs[0][0] == 7).all() and (flags[0] == 7).all()
            continue
        second, breakdown = decides
        w = w2 if second else w1
        assert flags[0][j] == float(breakdown)
        assert (Hs[0][0][:, j] != 7).all() and (Hs[0][0][:, j + 1:] == 7).all()
        if breakdown:
            assert _bitwise(outs[0][0], w[0]) and _bitwise(outs[0][1], w[1])
        else:
            assert not _bitwise(outs[0][0], w[0])
        want = df32.df_add(*h1, *c) if second else h1
        assert _bitwise(Hs[0][0][:j + 1, j], want[0][:j + 1])
        assert all(bool(torch.isfinite(t).all())
                   for t in (*outs[0], *Hs[0], flags[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m1,n,rows", [(7, 1000, 5), (1, 3000, 1)])
def test_project_source_is_bitwise(lib, dtype, m1, n, rows):
    """df_project at project_plan's launch (several blocks a row: the last
    block's tree, shared memory and shuffles), with acc."""
    rng = np.random.default_rng(m1 * n)
    Vh, Vl = _pair(rng, dtype, m1, n)
    wh, wl = _pair(rng, dtype, n)
    ah, al = _pair(rng, dtype, m1)
    acc = (ah.clone(), al.clone())
    want = df.df_project_plain(Vh, Vl, wh, wl, rows, acc)
    plan = df.project_plan(n, rows, Vh.element_size())
    assert plan.G > 1
    ch, cl = torch.full((m1,), 7.0, dtype=dtype), torch.full((m1,), 7.0,
                                                             dtype=dtype)
    part = torch.empty(2 * rows * plan.M, dtype=dtype)
    arrivals = torch.zeros(rows, dtype=torch.int32)
    gh, gl = ah.clone(), al.clone()
    assert getattr(lib, "df_project" + _word(dtype))(
        Vh.data_ptr(), Vl.data_ptr(), n, wh.data_ptr(), wl.data_ptr(), n,
        rows, m1, plan.T, plan.C, plan.G, plan.L, plan.stage, part.data_ptr(),
        part.numel(), arrivals.data_ptr(), rows, ch.data_ptr(), cl.data_ptr(),
        gh.data_ptr(), gl.data_ptr(), None) == 0
    assert _bitwise(ch, want[0]) and _bitwise(cl, want[1])
    assert _bitwise(gh, acc[0]) and _bitwise(gl, acc[1])
    assert not arrivals.any()


def test_eta_literals_are_the_rounded_constant():
    """The kernel's ETA is the word-rounded ETA of ops/df32.py, the
    value the plain version and the host's numpy scalars compare with."""
    text = CU.read_text()
    for word, ctype in ((np.float32, "float"), (np.float64, "double")):
        lit = re.search(rf"struct Eta<{ctype}> {{ static constexpr {ctype} "
                        rf"value = (0x[0-9a-f.]+p-?\d+)f?; }}", text).group(1)
        assert float.fromhex(lit) == float(word(ETA))


def _rank_sum_host(fn, parts, k, acc):
    """One launch of the host-built df_rank_sum on the gathered (P, 2k)
    buffer `parts` (each rank's k hi words, then its k lo words);
    (sh, sl)."""
    P = parts.shape[0]
    oh = torch.full((k,), 7.0, dtype=parts.dtype)
    ol = torch.full_like(oh, 7.0)
    ah, al = acc if acc is not None else (None, None)
    assert fn(parts.data_ptr(), parts[:, k:].data_ptr(), 2 * k, P, k,
              oh.data_ptr(), ol.data_ptr(),
              None if ah is None else ah.data_ptr(),
              None if al is None else al.data_ptr(), None) == 0
    return oh, ol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 8, 33, 256])
@pytest.mark.parametrize("with_acc", [False, True])
def test_rank_sum_source_is_bitwise(lib, dtype, P, with_acc):
    """df_rank_sum at k = 62 (a step's m + 2 at maxdim 60) on a gathered
    buffer, against df_rank_sum_plain (df_sum along the ranks): the ranks
    in shuffles alone (P <= 32, padded to a power of two) and folded in
    registers first (33 and 256); acc updated as df_project's acc.  Partials
    of mixed magnitude and sign, so the tree's order shows in the low
    words."""
    k = 62
    rng = np.random.default_rng(P + 10 * with_acc)
    scale = 2.0 ** rng.integers(-20, 20, size=(P, k))
    hi = torch.from_numpy(rng.standard_normal((P, k)) * scale).to(dtype)
    lo = (hi * 2.0 ** (-26 if dtype == torch.float32 else -55)
          * torch.from_numpy(rng.uniform(-1, 1, (P, k))).to(dtype))
    parts = torch.cat((hi, lo), dim=1).contiguous()
    acc = _pair(rng, dtype, k) if with_acc else None
    want_acc = None if acc is None else (acc[0].clone(), acc[1].clone())
    want = df.df_rank_sum_plain(parts[:, :k], parts[:, k:], want_acc)
    got_acc = None if acc is None else (acc[0].clone(), acc[1].clone())
    got = _rank_sum_host(getattr(lib, "df_rank_sum" + _word(dtype)), parts,
                         k, got_acc)
    assert _bitwise(got[0], want[0]) and _bitwise(got[1], want[1])
    if with_acc:
        assert _bitwise(got_acc[0], want_acc[0])
        assert _bitwise(got_acc[1], want_acc[1])


def test_rank_sum_plain_at_one_rank_is_the_partial():
    """At one rank the sum is the partial and acc + sum is df_project's acc:
    the one-rank sharded solve's bits are the unsharded ones."""
    rng = np.random.default_rng(4)
    Vh, Vl = _pair(rng, torch.float32, 7, 300)
    wh, wl = _pair(rng, torch.float32, 300)
    ah, al = _pair(rng, torch.float32, 7)
    acc = (ah.clone(), al.clone())
    want = df.df_project(Vh, Vl, wh, wl, 5, acc)
    ch, cl = df.df_project(Vh, Vl, wh, wl, 5)
    acc2 = (ah.clone(), al.clone())
    got = df.df_rank_sum(ch[None], cl[None], acc2)
    assert _bitwise(got[0], want[0]) and _bitwise(got[1], want[1])
    assert _bitwise(acc2[0], acc[0]) and _bitwise(acc2[1], acc[1])


def test_rank_sum_source_refuses_bad_launches(lib):
    x = torch.zeros(4, 8)
    fn = lib.df_rank_sum_f32
    good = dict(ld=8, P=4, k=4)

    def launch(ld, P, k, acc_h=None):
        return fn(x.data_ptr(), x.data_ptr(), ld, P, k, x.data_ptr(),
                  x.data_ptr(), acc_h, None, None)

    assert launch(**good) == 0
    for bad in ({"P": 0}, {"P": 257}, {"k": 0}, {"ld": 0},
                {"acc_h": x.data_ptr()}):
        assert launch(**{**good, **bad}) != 0, bad


def test_rank_sum_source_mutation_fails(mutant):
    """The swapped operand changes the sum: the comparison above sees it."""
    k, P = 62, 4
    rng = np.random.default_rng(9)
    hi, lo = _pair(rng, torch.float32, P, k)
    parts = torch.cat((hi, lo), dim=1).contiguous()
    want = df.df_rank_sum_plain(parts[:, :k], parts[:, k:])
    got = _rank_sum_host(mutant.df_rank_sum_f32, parts, k, None)
    assert not (_bitwise(got[0], want[0]) and _bitwise(got[1], want[1]))


# -- the gathered forms: the sums over the ranks folded by their consumer ----


def _host_kernel(library, monkeypatch):
    """ops/df.py's kernel wrapper (its checks, plans, chain of launches and
    C arguments) over a host-built library: CPU tensors, no stream."""
    K = df._DfKernel()

    def launch(entry, count, like, *args):
        assert getattr(library, entry + _word(like.dtype))(*args, None) == 0
        K.launches[count] += 1

    monkeypatch.setattr(K, "_launch", launch)
    monkeypatch.setattr(K, "_stream_scratch", lambda like, words, slots: (
        torch.full((max(words, 1),), 7.0, dtype=like.dtype),
        torch.zeros(max(slots, 1), dtype=torch.int32)))
    return K


@pytest.fixture
def host_kernel(lib, monkeypatch):
    return _host_kernel(lib, monkeypatch)


def _gathered(rng, dtype, P, m1):
    """A gathered record of P ranks' partials of a scalar sum and an m1
    vector (k = m1 + 1 coefficients), as RowComm.gather_partials lays it
    out: mixed magnitudes and signs, so the tree's order shows in the low
    words."""
    k = m1 + 1
    scale = 2.0 ** rng.integers(-20, 20, size=(P, k))
    hi = torch.from_numpy(rng.standard_normal((P, k)) * scale).to(dtype)
    lo = (hi * 2.0 ** (-26 if dtype == torch.float32 else -55)
          * torch.from_numpy(rng.uniform(-1, 1, (P, k))).to(dtype))
    return df.Gathered(torch.cat((hi, lo), dim=1).contiguous(), k, (0, 1))


def _same(got, want):
    return all(_bitwise(a.reshape(-1), b.reshape(-1))
               for a, b in zip(got, want))


def _axpy_gathered_case(K, dtype, P, n, rows, norm, seed):
    """df_axpy's gathered form through the wrapper K against
    df_rank_sum_plain followed by df_axpy_plain: the result (and its fused
    sum) and the folded record, bit for bit."""
    rng = np.random.default_rng(seed)
    m1 = max(rows, 1)
    w, V = _pair(rng, dtype, n), _pair(rng, dtype, m1, n)
    g = _gathered(rng, dtype, P, m1)
    sh, sl = df.df_rank_sum_plain(g.hi, g.lo)
    want = df.df_axpy_plain(*w, sh[1:], sl[1:], *V, rows, norm)
    got, folded = K.axpy_gathered(*w, g, *V, rows, norm)
    flat = (lambda r: (*r[0], *r[1])) if norm else (lambda r: r)
    return _same(flat(got), flat(want)) and _same(folded, (sh, sl))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 8, 33])
@pytest.mark.parametrize("rows", [1, 61])
@pytest.mark.parametrize("norm", [False, True])
def test_axpy_gathered_source_is_bitwise(host_kernel, dtype, P, rows, norm):
    """df_axpy with its coefficients a gathered record (a sharded step's
    {r2, h1}), folded over the ranks in every block's prologue: bitwise
    df_rank_sum_plain followed by df_axpy_plain, the result, its fused
    sum and the whole record block 0 writes; one launch, counted as
    gathered.  P <= 32 in shuffles alone (padded to a power of two), 33
    folded in registers first."""
    assert _axpy_gathered_case(host_kernel, dtype, P, 1000, rows, norm,
                               P + 100 * rows + norm)
    assert host_kernel.gathered == {"df_axpy": 1, "df_normalize": 0}
    assert host_kernel.launches["df_axpy"] == 1
    assert host_kernel.launches["df_rank_sum"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_axpy_gathered_source_chains_past_a_launch(host_kernel, dtype):
    """More rows than a launch stages (_AXPY_MAX_ROWS): each launch folds
    its slice of the record's coefficients, the first writes the record,
    the last fuses the norm."""
    rows = df._AXPY_MAX_ROWS + 44
    assert _axpy_gathered_case(host_kernel, dtype, 3, 200, rows, True, 5)
    assert host_kernel.gathered["df_axpy"] == 2
    assert host_kernel.axpy_forms == {"plain": 1, "norm": 1}


@pytest.mark.parametrize("P", [3, 33])
def test_axpy_gathered_source_in_blocks_under_a_warp(host_kernel, P):
    """n = 10 takes blocks of 16 threads: the fold's groups shrink to the
    block (16 lanes, 33 ranks folded 4 a lane in registers), the same
    bits; 256 ranks would need 16 a lane and are refused."""
    assert df.axpy_plan(10, 4, 4, True).T == 16
    assert _axpy_gathered_case(host_kernel, torch.float32, P, 10, 4, True, P)
    with pytest.raises(ValueError, match="256 ranks in blocks of 16"):
        _axpy_gathered_case(host_kernel, torch.float32, 256, 10, 4, True, 0)


def test_axpy_gathered_source_refuses_bad_records(lib):
    """A valid gathered launch of 64 elements, then each record field made
    invalid: ranks past 256, no stride, a slice of coefficients past the
    record, one folded word without the other."""
    w = torch.zeros(256)
    fn = lib.df_axpy_f32
    good = dict(ld=8, ranks=4, k=4, h_off=1, fold_h=w.data_ptr(),
                fold_l=w.data_ptr())

    def launch(ld, ranks, k, h_off, fold_h, fold_l):
        return fn(*[w.data_ptr()] * 6, 64, 3, 64, 8, 1, 0, 8, 8, ld, ranks,
                  k, h_off, fold_h, fold_l, None, 0, None, 0, w.data_ptr(),
                  w.data_ptr(), None, None)

    assert launch(**good) == 0
    for bad in ({"ranks": 257}, {"ranks": -1}, {"ld": 0}, {"k": 3},
                {"h_off": 2}, {"fold_l": None}):
        assert launch(**{**good, **bad}) != 0, bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 2, 3, 8, 33])
@pytest.mark.parametrize("case", ["first", "second", "second_breakdown",
                                  "zero"])
def test_normalize_gathered_s2_source_is_bitwise(host_kernel, dtype, P, case):
    """df_normalize's step form with s2 a gathered record of one sum,
    folded by every block before its decision: the row, H's column j and
    flags[j] bitwise df_rank_sum_plain followed by df_normalize_plain, in
    every decision (a breakdown among them)."""
    rng = np.random.default_rng(P + len(case))
    n, m1, m, j = 1003, 7, 6, 3
    (r2, s1, s2), (second, breakdown) = NORMALIZE_CASES[case]
    w1, w2 = _pair(rng, dtype, n), _pair(rng, dtype, n)
    if case == "zero":
        for t in (*w1, *w2):
            t.zero_()
    h1, c = _pair(rng, dtype, m1), _pair(rng, dtype, m1)
    # Rank 0 holds most of s2, the others small parts of either sign.
    parts = np.full(P, s2 * 1e-3) * rng.uniform(-1, 1, P)
    parts[0] = s2 - parts[1:].sum()
    lo = 2.0 ** (-27 if dtype == torch.float32 else -56)
    buf = torch.from_numpy(np.stack((parts, parts * lo), axis=1)).to(dtype)
    g = df.Gathered(buf.contiguous(), 1, (0,))
    sh, sl = df.df_rank_sum_plain(g.hi, g.lo)
    outs = []
    for kernel in (True, False):
        out = (torch.full((n,), 7.0, dtype=dtype),
               torch.full((n,), 7.0, dtype=dtype))
        H = (torch.full((m1, m), 7.0, dtype=dtype),
             torch.full((m1, m), 7.0, dtype=dtype))
        flags = torch.full((m,), 7.0, dtype=dtype)
        step = df.DgksStep(_sum(r2, dtype), w2, g if kernel else (sh[0], sl[0]),
                           h1, c, H, j, flags)
        if kernel:
            host_kernel.normalize(w1, _sum(s1, dtype), out, step)
        else:
            df.df_normalize_plain(w1, _sum(s1, dtype), out, step)
        outs.append((*out, *H, flags))
    assert _same(outs[0], outs[1])
    assert float(outs[0][4][j]) == float(breakdown)
    assert host_kernel.gathered == {"df_axpy": 0, "df_normalize": 1}
    # The plain version's gathered form is the same sum, then the same step.
    out = tuple(torch.full((n,), 7.0, dtype=dtype) for _ in range(2))
    H = tuple(torch.full((m1, m), 7.0, dtype=dtype) for _ in range(2))
    flags = torch.full((m,), 7.0, dtype=dtype)
    df.df_normalize_plain(w1, _sum(s1, dtype), out, df.DgksStep(
        _sum(r2, dtype), w2, g, h1, c, H, j, flags))
    assert _same((*out, *H, flags), outs[1])


def test_normalize_gathered_s2_refusals(host_kernel):
    """A gathered s2 is one sum of the step form."""
    x = torch.zeros(8)
    H = (torch.zeros(3, 2), torch.zeros(3, 2))
    two = df.Gathered(torch.zeros(2, 4), 2, (0, 1))
    with pytest.raises(ValueError, match="one sum"):
        host_kernel.normalize((x, x), (x[0], x[0]), (x, x), df.DgksStep(
            (x[0], x[0]), (x, x), two, (x[:3], x[:3]), (x[:3], x[:3]), H, 0,
            x[:2]))


def test_gathered_forms_source_mutation_fails(mutant, monkeypatch):
    """rank_fold's swapped operand changes the folded record of df_axpy's
    gathered form and df_normalize's decision from a gathered s2: the
    comparisons above see it."""
    K = _host_kernel(mutant, monkeypatch)
    rng = np.random.default_rng(8)
    w, V = _pair(rng, torch.float32, 300), _pair(rng, torch.float32, 7, 300)
    g = _gathered(rng, torch.float32, 4, 7)
    _, folded = K.axpy_gathered(*w, g, *V, 7, True)
    assert not _same(folded, df.df_rank_sum_plain(g.hi, g.lo))
    parts = torch.tensor([[9.0, 1e-7], [-7.5, 3e-8], [0.25, -1e-8],
                          [1e-3, 2e-9]])
    g = df.Gathered(parts, 1, (0,))
    sh, sl = df.df_rank_sum_plain(g.hi, g.lo)
    w1, w2 = _pair(rng, torch.float32, 64), _pair(rng, torch.float32, 64)
    rows = []
    for s2 in (g, (sh[0], sl[0])):
        out = (torch.zeros(64), torch.zeros(64))
        zeros = (torch.zeros(7), torch.zeros(7))
        step = df.DgksStep(_sum(9.0, torch.float32), w2, s2, zeros, zeros,
                           (torch.zeros(7, 6), torch.zeros(7, 6)), 3,
                           torch.zeros(6))
        (K.normalize if s2 is g else df.df_normalize_plain)(
            w1, _sum(2.25, torch.float32), out, step)
        rows.append(out)
    assert not _same(rows[0], rows[1])
