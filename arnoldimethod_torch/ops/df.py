"""The double-word kernels of the extended-precision path: CUDA kernels
(`csrc/df.cu`) and their plain PyTorch versions.

    df_project       (ch, cl)[j] = sum_i V[j, i] * w[i] for rows j < rows,
                     zero beyond; optionally acc <- acc + c in place
    df_axpy          w - sum_{j < rows} h_j * V[j], j in order; with
                     norm=True also the double-word sum of squares of the
                     result (df_project's one row on it), in the same launch
    df_normalize     w / ||w|| from w's double-word sum of squares on the
                     card; in its step form also the DGKS step's decisions
                     (second pass, breakdown), its H column and its flag
    df_basis_change  out[i] = sum_j Q[j, i] * V[j], j in order, for the
                     first `rows` rows i, optionally into V itself
    stencil5_df      the Dirichlet 5-point stencil (center, west, east,
                     north, south) applied to a double-word vector
    df_rank_sum      the double-word sum over the ranks of a row-sharded
                     solve of their gathered partials (a `Gathered`
                     record), by df32.df_sum's tree along the rank axis;
                     optionally acc <- acc + sum

A row-sharded Krylov step folds its sums over the ranks inside the kernels
that consume them: `df_axpy_gathered` takes its coefficients as a gathered
record and also writes the record's sums; df_normalize's step form takes
s2 as one.  df_rank_sum is the fold alone, for the sums outside a step.

Every operand is a double-word pair of float32 or float64 words; every
product and sum is the one `ops/df32.py` makes, in its order, so each
kernel is bitwise equal to its plain version, and with float32 words both
are bitwise equal to the JAX package's ops/df32.py and df_expansion.py.

No TPU kernel stands behind these: the JAX package runs the same work as
XLA loops and branches (`lax.scan`, `fori_loop`, the tree of `df_sum`,
`lax.cond`).  In plain PyTorch each of those ops is one launch, thousands
per Krylov step, so the double-word work has kernels of its own.  Why CUDA
and not Triton:
Triton contracts a*b + c into an FMA by default, which would break the
error-free transforms; the CUDA source rounds every step explicitly.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel, built with nvcc at first use, or raises.  Nothing
falls back from the kernel to the plain version.  `KERNEL.launches` counts
the launches of each kernel (`project_forms` and `axpy_forms` split
df_project's and df_axpy's by form; `gathered` counts df_axpy's and
df_normalize's launches in their gathered forms).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._build import PACKAGE_DIR, build_shared, nvcc_command
from . import df32
from .df32 import ETA

__all__ = [
    "KERNEL",
    "AxpyPlan",
    "BasisPlan",
    "DgksStep",
    "Gathered",
    "ProjectPlan",
    "StencilPlan",
    "axpy_plan",
    "basis_plan",
    "coefficient_words",
    "df_axpy",
    "df_axpy_gathered",
    "df_axpy_gathered_plain",
    "df_axpy_plain",
    "df_basis_change",
    "df_basis_change_plain",
    "df_normalize",
    "df_normalize_plain",
    "df_project",
    "df_project_plain",
    "df_rank_sum",
    "df_rank_sum_plain",
    "dirichlet_shifts",
    "project_plan",
    "stencil5_df",
    "stencil5_df_plain",
    "stencil_plan",
]

_SOURCE = PACKAGE_DIR / "csrc" / "df.cu"
# df_project (csrc/df.cu kProjectThreads, kProjectStage, kMaxFold): the
# most threads a block, the shared memory a block and the largest fold L.
# The plan folds 2^L elements a thread, as far as the grid keeps
# _MIN_BLOCKS blocks, up to 16 for one row and 8 for more; a warp reads
# runs of 32 bytes for one row and 128 for more.  All four were measured
# on an H100 (PERF.md §6): a wider grid or longer runs lose more in the
# last block's sum over the partials than they gain in reading.
_PROJECT_THREADS = 256
_PROJECT_STAGE_BYTES = 48 * 1024
_MIN_BLOCKS = 64
_MAX_FOLD = {"one_row": 4, "full": 3}
_RUN_BYTES = {"one_row": 32, "full": 128}
# df_basis_change (csrc/df.cu): the tiles (R rows by C columns a thread)
# instantiated for a word of `item` bytes, the plan's first (the fastest
# on an H100, PERF.md §6), and the most rows a block sums (csrc/df.cu
# kBasisSlabRows: 64 / R warps, one row group each).
# _BASIS_STAGE_BYTES bounds m1 as the first kernel did (a column of both
# words of every row in 48 KB), so every caller's range of m1 stays what
# it was.
_BASIS_TILES = {4: ((8, 2), (16, 2), (4, 4)), 8: ((4, 2), (8, 2))}
_BASIS_SLAB_ROWS = 64
_BASIS_STAGE_BYTES = 48 * 1024
# df_axpy (csrc/df.cu kAxpyThreads, kAxpyMaxRows, DF_AXPY_SHAPES): the
# most threads a block, rows of V a launch (more are chained), and the
# (L, U) instantiated: 2^L elements a thread, U rows of them loaded into
# registers before their arithmetic.  The plan's choices, the fastest on an H100 (PERF.md §6,
# `chip_smoke.py --axpy-sweep`): where one element a thread gives at most
# _AXPY_FEW_BLOCKS blocks (config 3's n, whose basis stays in the 50 MB
# L2), L = 0 and 64 bytes of each word a thread a group; else L = 1, U = 2
# (plain) or L = 3, U = 2 (the fused norm: fewer blocks, fewer partials).
# The plain form reads runs of a whole block (C = T), the fused norm runs
# of _AXPY_RUN_BYTES (its last block sums G C partials, and holds up to
# _AXPY_SUM_PAIRS of them in shared memory).
_AXPY_THREADS = 256
_AXPY_MAX_ROWS = 256
_AXPY_SHAPES = ((0, 4), (0, 8), (0, 16), (1, 2), (1, 4), (1, 8), (2, 1),
                (2, 2), (2, 4), (3, 1), (3, 2))
_AXPY_FEW_BLOCKS = 512
_AXPY_FEW_BYTES = 64
_AXPY_MANY = {False: (1, 2), True: (3, 2)}
_AXPY_RUN_BYTES = 128
_AXPY_SUM_PAIRS = 2048
# stencil5_df (csrc/df.cu kStencilWarps): warps a block, and the blocks a
# plan keeps where it can: two on each of an H100's 132 SMs.
_STENCIL_WARPS = 4
_STENCIL_MIN_BLOCKS = 2 * 132
# The sums over the ranks (csrc/df.cu kMaxRanks, kRankFold): 32 lanes
# folding 8 ranks each.
_RANK_SUM_MAX_RANKS = 256
_RANK_FOLD = 8


class Gathered(NamedTuple):
    """Every rank's partial sums of a row-sharded solve, gathered
    (parallel.comm.RowComm.gather_partials): `buf` (P, 2k), rank r's k hi
    words then its k lo words; `offsets` the first column of each part (a
    scalar sum, then a vector of coefficients).  Their sums over the ranks
    are df_rank_sum(hi, lo), or folded by the kernel that consumes them."""

    buf: torch.Tensor
    k: int
    offsets: tuple

    @property
    def hi(self):
        return self.buf[:, :self.k]

    @property
    def lo(self):
        return self.buf[:, self.k:]


def _check_ranks(P, threads=32):
    """Raise ValueError unless csrc/df.cu's rank_fold takes P ranks in
    blocks of `threads` (its rank_plan): P padded to a power of two P',
    min(P', 32, threads) lanes a coefficient, at most 8 ranks a lane (P <=
    256; fewer in blocks of fewer than 32 threads)."""
    width = 1 << max(0, P - 1).bit_length()
    if not 1 <= P <= _RANK_SUM_MAX_RANKS or width // min(width, 32,
                                                         threads) > _RANK_FOLD:
        raise ValueError(
            f"a sum over {P} ranks in blocks of {threads} threads: the fold "
            f"takes 1 to {_RANK_SUM_MAX_RANKS} ranks, at most {_RANK_FOLD} "
            f"a lane")


class ProjectPlan(NamedTuple):
    """df_project's launch over rows of length n (padded to N = 2^k): the
    index splits, top bit to bottom, into [h | wt | b | c] with
    N = 2^L * T * G: thread (wt, c) of block b of a row holds the 2^L
    elements h; T = (T / C) * C threads a block; G blocks a row."""

    form: str   # "one_row" (at most one row: every norm) or "full"
    T: int      # threads a block (a power of two)
    C: int      # elements of a warp's runs, the lowest bits
    G: int      # blocks a row
    L: int      # elements a thread folds: 2^L
    stage: int  # the most partials the last block holds in shared memory

    @property
    def M(self):
        """Partial sums a row: the G blocks' C each."""
        return self.G * self.C


def project_plan(n, rows=1, item=4):
    """The launch of df_project over `rows` rows of length n in words of
    `item` bytes (see _MIN_BLOCKS)."""
    N = 1 << max(0, n - 1).bit_length()
    T = min(_PROJECT_THREADS, N)
    form = "one_row" if rows <= 1 else "full"
    C = min(_RUN_BYTES[form] // item, T)
    L = max((L for L in range(_MAX_FOLD[form] + 1)
             if T << L <= N and N // (T << L) * rows >= _MIN_BLOCKS),
            default=0)
    G = N // (T << L)
    cap = _PROJECT_STAGE_BYTES // (2 * item)
    stage = min(1 << (cap.bit_length() - 1), G * C)
    return ProjectPlan(form, T, C, G, L, stage)


class AxpyPlan(NamedTuple):
    """df_axpy's launch over n elements (padded to N = 2^k): thread (wt, c)
    of block b owns the 2^L elements h of the split [h | wt | b | c] of
    df_project's plan, N = 2^L * T * G, and loads U rows of them at a
    time."""

    T: int      # threads a block (a power of two)
    C: int      # elements of a warp's runs, the lowest bits
    G: int      # blocks
    L: int      # elements a thread: 2^L
    U: int      # rows a thread loads before their arithmetic
    stage: int  # the most partials the norm's last block holds in shared memory

    @property
    def M(self):
        """The fused norm's partial sums: the G blocks' C each."""
        return self.G * self.C

    def smem(self, rows, item, norm):
        """Shared memory a block, bytes: the h records, or the norm's
        max(T, stage) pairs (csrc/df.cu axpy)."""
        return max(rows * 4 * item, 2 * max(self.T, self.stage) * item if norm else 0)


@functools.lru_cache(maxsize=256)
def axpy_plan(n, rows=1, item=4, norm=False):
    """The launch of df_axpy over `rows` (at most _AXPY_MAX_ROWS) rows of
    length n in words of `item` bytes, with or without the fused norm (see
    _AXPY_FEW_BLOCKS)."""
    N = 1 << max(0, n - 1).bit_length()
    T = min(_AXPY_THREADS, N)
    few = N // T <= _AXPY_FEW_BLOCKS
    L, U = (0, _AXPY_FEW_BYTES // item) if few else _AXPY_MANY[norm]
    C = min(_AXPY_RUN_BYTES // item, T) if norm else T
    G = N // (T << L)
    return AxpyPlan(T, C, G, L, U, min(_AXPY_SUM_PAIRS, G * C))


class BasisPlan(NamedTuple):
    """df_basis_change's launch: a thread sums R rows by C columns (one
    vector load of each word); a block W warps, one row group each, over a
    tile of 32 C columns; `slabs` blocks down the rows, `blocks` across."""

    R: int       # output rows a thread
    C: int       # columns a thread
    W: int       # warps a block
    J: int       # rows j of V and Q a shared stage holds
    slabs: int   # row slabs of W R rows (grid y)
    blocks: int  # column tiles of 32 C (grid x)
    smem: int    # shared memory a block, bytes (two stages)

    @property
    def in_place(self):
        """One slab: a block reads all rows of its columns before it
        writes, so the output may be V itself."""
        return self.slabs == 1


def basis_plan(m1, n, rows, item=4, tile=None):
    """The launch of df_basis_change over an m1 x n basis, computing the
    first `rows` output rows, in words of `item` bytes; `tile` (R, C), one
    of _BASIS_TILES[item], replaces the default when measuring tiles."""
    R, C = tile or _BASIS_TILES[item][0]
    groups = -(-rows // R)
    W = min(groups, _BASIS_SLAB_ROWS // R)
    J = 32 // R
    smem = 2 * (J * W * R * 4 * item + J * 2 * 32 * C * item)
    return BasisPlan(R, C, W, J, -(-groups // W), -(-n // (32 * C)), smem)


class StencilPlan(NamedTuple):
    """stencil5_df's launch: tiles of 32 columns by 4 P rows, one column
    and P rows a thread, 4 warps a block, a block a tile."""

    P: int       # points (rows) a thread
    blocks: int  # tiles


@functools.lru_cache(maxsize=64)
def stencil_plan(ny, nx, item=4):
    """The most points a thread, up to 16 / item (4 for float32 words, 2
    for float64: the fastest at 1024^2 on an H100, PERF.md §6), that keeps
    _STENCIL_MIN_BLOCKS tiles, else one."""
    cols = -(-nx // 32)
    for P in (4, 2, 1):
        blocks = cols * -(-ny // (_STENCIL_WARPS * P))
        if P * item <= 16 and (blocks >= _STENCIL_MIN_BLOCKS or P == 1):
            return StencilPlan(P, blocks)


def coefficient_words(coeffs, dtype):
    """The five stencil coefficients rounded to the word type, then their
    hi halves, then their lo halves (df32.split on host scalars: the values
    a split in the kernel would make), as floats."""
    word = np.float32 if dtype == torch.float32 else np.float64
    cs = [word(c) for c in coeffs]
    halves = [df32.split(c) for c in cs]
    return [float(v) for v in (*cs, *(h for h, _ in halves),
                               *(lo for _, lo in halves))]


# -- plain versions ---------------------------------------------------------


def df_project_plain(Vh, Vl, wh, wl, rows, acc=None):
    """The plain version of df_project (df32.df_project_coeffs_df on the
    leading rows, zeros beyond; then acc <- df_add(acc, c))."""
    m1 = Vh.shape[0]
    ch = torch.zeros(m1, dtype=Vh.dtype, device=Vh.device)
    cl = torch.zeros_like(ch)
    if rows > 0:
        ch[:rows], cl[:rows] = df32.df_project_coeffs_df(
            Vh[:rows], Vl[:rows], wh, wl)
    if acc is not None:
        ah, al = df32.df_add(acc[0], acc[1], ch, cl)
        acc[0].copy_(ah)
        acc[1].copy_(al)
    return ch, cl


def df_axpy_plain(wh, wl, hh, hl, Vh, Vl, rows, norm=False):
    """The plain version of df_axpy (df32.df_axpy_update_df); with norm,
    also the sum of squares of the result by df_project's one-row form
    (df32.df_sum(df_mul(out, out)), df_norm's sum)."""
    out = df32.df_axpy_update_df(wh, wl, hh[:rows], hl[:rows], Vh[:rows],
                                 Vl[:rows])
    if not norm:
        return out
    ch, cl = df_project_plain(out[0][None], out[1][None], *out, 1)
    return out, (ch[0], cl[0])


def df_axpy_gathered_plain(wh, wl, g, Vh, Vl, rows, norm=False):
    """The plain version of df_axpy_gathered: df_rank_sum_plain of the
    record, then df_axpy_plain with its last part as h."""
    sh, sl = df_rank_sum_plain(g.hi, g.lo)
    h = g.offsets[-1]
    return df_axpy_plain(wh, wl, sh[h:], sl[h:], Vh, Vl, rows, norm), (sh, sl)


def _scalar(v, like):
    """A 0-dim tensor of `like`'s dtype on the CPU (a host scalar)."""
    return torch.as_tensor(v, dtype=like.dtype, device="cpu")


class DgksStep(NamedTuple):
    """What df_normalize's step form takes beside w1 and its sum: the rest
    of a DGKS step j (ops/df_expansion.py) and where its results go.
    Every pair is (hi, lo); every sum a pair of 0-dim tensors, s2 also a
    `Gathered` record of one part (a sharded step's partials, summed over
    the ranks inside the launch)."""

    r2: tuple     # the matvec's sum of squares
    w2: tuple     # the second Gram-Schmidt pass's result (n)
    s2: tuple     # its sum of squares, or its gathered partials
    h1: tuple     # the first pass's coefficients (m1)
    c: tuple      # the second pass's coefficients (m1)
    H: tuple      # the Hessenberg pair (m1, m): column j is written
    j: int
    flags: torch.Tensor  # (m,) of the word type: flags[j] = breakdown


def _eta_times(x):
    """ETA * x in x's word type, ETA rounded to the word first (as the
    host's numpy scalars and the kernel round it)."""
    return torch.full_like(x, ETA) * x


def df_normalize_plain(w, s, out, step=None):
    """The plain version of df_normalize: df32's ops on 0-dim tensors and
    torch.where in place of the host's branches; a gathered s2 first
    summed by df_rank_sum_plain."""
    if step is not None and isinstance(step.s2, Gathered):
        sh, sl = df_rank_sum_plain(step.s2.hi, step.s2.lo)
        step = step._replace(s2=(sh[0], sl[0]))
    nh, nl = df32.df_sqrt(*s)
    wh, wl = w
    if step is not None:
        rnorm = df32.df_sqrt(*step.r2)[0]
        second = nh < _eta_times(rnorm)
        n2h, n2l = df32.df_sqrt(*step.s2)
        ref = torch.where(second, nh, rnorm)
        nh, nl = torch.where(second, n2h, nh), torch.where(second, n2l, nl)
        breakdown = nh <= _eta_times(ref)
        wh = torch.where(second, step.w2[0], wh)
        wl = torch.where(second, step.w2[1], wl)
    ih, il = df32.df_inv(nh, nl)
    yh, yl = df32.df_mul(wh, wl, ih, il)
    if step is not None:
        yh, yl = torch.where(breakdown, wh, yh), torch.where(breakdown, wl, yl)
        ah, al = df32.df_add(*step.h1, *step.c)
        Hh, Hl = step.H
        Hh[:, step.j] = torch.where(second, ah, step.h1[0])
        Hl[:, step.j] = torch.where(second, al, step.h1[1])
        Hh[step.j + 1, step.j] = nh
        Hl[step.j + 1, step.j] = nl
        step.flags[step.j] = breakdown
    out[0].copy_(yh)
    out[1].copy_(yl)
    return out


def df_rank_sum_plain(hi, lo, acc=None):
    """The plain version of df_rank_sum: df32.df_sum along axis 0 of the
    (P, k) pair, then acc <- df_add(acc, sum) as df_project_plain adds."""
    sh, sl = df32.df_sum(hi, lo, axis=0)
    if acc is not None:
        ah, al = df32.df_add(acc[0], acc[1], sh, sl)
        acc[0].copy_(ah)
        acc[1].copy_(al)
    return sh, sl


def df_basis_change_plain(Vh, Vl, Qh, Ql, rows=None, out=None):
    """The plain version of df_basis_change: the JAX package's scan over the
    rows of V, accumulating df_mul(Q[j, :rows, None], V[j]) with df_add
    (every op elementwise, so the first `rows` rows are those of the full
    result).  With `out`, a pair of at least `rows` rows (V itself among
    them), the result is copied into its first rows."""
    rows = Vh.shape[0] if rows is None else rows
    outh = torch.zeros((rows, Vh.shape[1]), dtype=Vh.dtype, device=Vh.device)
    outl = torch.zeros_like(outh)
    for j in range(Vh.shape[0]):
        th, tl = df32.df_mul(Qh[j, :rows, None], Ql[j, :rows, None],
                             Vh[j][None, :], Vl[j][None, :])
        outh, outl = df32.df_add(outh, outl, th, tl)
    if out is None:
        return outh, outl
    out[0][:rows].copy_(outh)
    out[1][:rows].copy_(outl)
    return out[0][:rows], out[1][:rows]


def dirichlet_shifts(g):
    """The west, east, north and south reads of grid g, zero-padded."""
    gp = F.pad(g, (1, 1, 1, 1))
    return gp[1:-1, :-2], gp[1:-1, 2:], gp[:-2, 1:-1], gp[2:, 1:-1]


def stencil5_df_plain(xh, xl, coeffs, grid, shifts=dirichlet_shifts):
    """The plain version of stencil5_df (the JAX package's
    Stencil5Operator.matvec_df): df_scale of the center, then df_add of
    each scaled neighbour in the order west, east, north, south.  `shifts`
    gives the four neighbour reads of a grid (a torus for a periodic
    stencil)."""
    ny, nx = grid
    gh, gl = xh.reshape(ny, nx), xl.reshape(ny, nx)
    cs = [_scalar(c, xh) for c in coeffs]
    yh, yl = df32.df_scale(gh, gl, cs[0])
    for cf, sh, sl in zip(cs[1:], shifts(gh), shifts(gl)):
        th, tl = df32.df_scale(sh, sl, cf)
        yh, yl = df32.df_add(yh, yl, th, tl)
    return yh.reshape(ny * nx), yl.reshape(ny * nx)


# -- the CUDA kernels -------------------------------------------------------

_NAMES = ("df_project", "df_axpy", "df_normalize", "df_basis_change",
          "stencil5_df", "df_rank_sum")


def _check(*tensors):
    """One word dtype (float32/float64) and one CUDA device; contiguous."""
    dtype, device = tensors[0].dtype, tensors[0].device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the double-word kernels take float32 or float64, got {dtype}")
    for t in tensors:
        if t.dtype != dtype or t.device != device:
            raise ValueError("double-word operands must share dtype and device")
        if not t.is_contiguous():
            raise ValueError("the double-word kernels take contiguous tensors")


class _DfKernel:
    """The built CUDA library of csrc/df.cu and the launch count of each of
    its kernels (`launches[name]`, one a launch); `project_forms` splits
    df_project's launches by their plan's form (ProjectPlan.form),
    `axpy_forms` df_axpy's into the plain form and the fused norm, and
    `gathered` counts df_axpy's and df_normalize's launches that fold a
    gathered record (in `launches` too)."""

    def __init__(self):
        self.launches = dict.fromkeys(_NAMES, 0)
        self.project_forms = {"one_row": 0, "full": 0}
        self.axpy_forms = {"plain": 0, "norm": 0}
        self.gathered = {"df_axpy": 0, "df_normalize": 0}
        self.build_log = ""
        self._lib = None
        self._scratch = {}
        self._retired = []

    def load(self):
        """Build (once per source hash) and load the library."""
        if self._lib is None:
            path, self.build_log = build_shared(
                "df", [_SOURCE],
                [*nvcc_command("double-word"), "-fmad=false"])
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int64
            sigs = {
                "df_project": [p, p, i, p, p, i, i, i, i, i, i, i, i, p, i, p,
                               i, p, p, p, p, p],
                "df_axpy": [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                            i, i, p, p, p, i, p, i, p, p, p, p],
                "df_normalize": [p] * 10 + [i, p, p, p, p, i, p, p, i, i, p,
                                            p, p, i, i, p],
                "df_basis_change": [p, p, p, p, i, i, i, i, i, i, p, p, p],
                "stencil5_df": [p, p, p, p, i, i, i, p, p],
                "df_rank_sum": [p, p, i, i, i, p, p, p, p],
            }
            for name, args in sigs.items():
                for suffix in ("_f32", "_f64"):
                    fn = getattr(lib, name + suffix)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _launch(self, entry, count, like, *args):
        """Launch C entry `entry` (its _f32/_f64 form by `like`'s dtype) on
        the current stream of `like`'s device; raise on a CUDA error; add
        one to launches[count]."""
        lib = self.load()
        fn = getattr(lib, entry + ("_f32" if like.dtype == torch.float32 else "_f64"))
        with torch.cuda.device(like.device):
            stream = torch.cuda.current_stream(like.device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
        self.launches[count] += 1

    def _project_scratch(self, like, words, slots, stream, capturing=False):
        """df_project's partials (`words` of like's dtype) and arrival
        counters (`slots`, one a row, int32), kept per (device, dtype,
        stream) and grown by doubling, so that calls on two streams never
        share them.  The counters are zeroed when allocated and every
        launch leaves them zero.  An outgrown buffer is kept, not freed: a
        CUDA graph captured earlier may still launch on it.  A graph
        captured on a stream shares that stream's buffers when they are
        large enough (so do not call df_project on that stream while the
        graph replays on another); else a call under capture takes buffers
        of its own from the graph's pool, zeroed by a memset in the graph."""
        key = (like.device, like.dtype, stream)
        part, arrivals = self._scratch.get(key, (None, None))
        if part is not None and part.numel() >= words and arrivals.numel() >= slots:
            return part, arrivals
        if capturing:
            return (torch.empty(max(words, 1), dtype=like.dtype, device=like.device),
                    torch.zeros(max(slots, 1), dtype=torch.int32, device=like.device))

        def grow(old, need, make):
            if old is not None and old.numel() >= need:
                return old
            if old is not None:
                self._retired.append(old)
            return make(max(need, 2 * (0 if old is None else old.numel()), 1))

        part = grow(part, words, lambda k: torch.empty(
            k, dtype=like.dtype, device=like.device))
        arrivals = grow(arrivals, slots, lambda k: torch.zeros(
            k, dtype=torch.int32, device=like.device))
        self._scratch[key] = (part, arrivals)
        return part, arrivals

    def project(self, Vh, Vl, wh, wl, rows, acc=None):
        _check(Vh, Vl, wh, wl, *(acc or ()))
        m1, n = Vh.shape
        if not 0 <= rows <= m1 or wh.shape != (n,) or wl.shape != (n,):
            raise ValueError(f"df_project: rows={rows}, V {tuple(Vh.shape)}, "
                             f"w {tuple(wh.shape)}")
        plan = project_plan(n, max(rows, 1), Vh.element_size())
        return self._project_launch(plan, Vh, Vl, wh, wl, rows, acc)

    def _stream_scratch(self, like, words, slots):
        """_project_scratch on the current stream of `like`'s device."""
        with torch.cuda.device(like.device):
            stream = torch.cuda.current_stream(like.device).cuda_stream
            capturing = torch.cuda.is_current_stream_capturing()
        return self._project_scratch(like, words, slots, stream, capturing)

    def _project_launch(self, plan, Vh, Vl, wh, wl, rows, acc=None):
        """df_project's launch under `plan` (project_plan's, or another
        when measuring plans); the operands are checked by `project`."""
        m1, n = Vh.shape
        part, arrivals = self._stream_scratch(Vh, 2 * rows * plan.M, rows)
        ch = torch.empty(m1, dtype=Vh.dtype, device=Vh.device)
        cl = torch.empty_like(ch)
        ah, al = acc if acc is not None else (None, None)
        self._launch("df_project", "df_project", Vh, Vh.data_ptr(),
                     Vl.data_ptr(), n, wh.data_ptr(), wl.data_ptr(), n, rows,
                     m1, plan.T, plan.C, plan.G, plan.L, plan.stage,
                     part.data_ptr(), part.numel(), arrivals.data_ptr(),
                     arrivals.numel(), ch.data_ptr(), cl.data_ptr(),
                     None if ah is None else ah.data_ptr(),
                     None if al is None else al.data_ptr())
        self.project_forms[plan.form] += 1
        return ch, cl

    def axpy(self, wh, wl, hh, hl, Vh, Vl, rows, norm=False):
        _check(wh, wl, hh, hl, Vh, Vl)
        n = wh.shape[0]
        if (not 0 <= rows <= min(Vh.shape[0], hh.shape[0]) or Vh.dim() != 2
                or Vh.shape[1] != n or Vl.shape != Vh.shape
                or wl.shape != wh.shape or hl.shape != hh.shape):
            raise ValueError("df_axpy: rows or shapes out of range")
        return self._axpy_chain(wh, wl, hh, hl, Vh, Vl, rows, norm)

    def axpy_gathered(self, wh, wl, g, Vh, Vl, rows, norm=False):
        _check(wh, wl, Vh, Vl, g.buf)
        n = wh.shape[0]
        P, k, h = g.buf.shape[0], g.k, g.offsets[-1]
        if (not 0 <= rows <= Vh.shape[0] or Vh.dim() != 2 or Vh.shape[1] != n
                or Vl.shape != Vh.shape or wl.shape != wh.shape
                or g.buf.shape != (P, 2 * k) or not 0 <= h <= k - rows):
            raise ValueError("df_axpy: rows or shapes out of range")
        folded = torch.empty(2, k, dtype=wh.dtype, device=wh.device)
        out = self._axpy_chain(wh, wl, g.hi, g.lo, Vh, Vl, rows, norm,
                               (g, h, folded))
        return out, (folded[0], folded[1])

    def _axpy_chain(self, wh, wl, hh, hl, Vh, Vl, rows, norm, gathered=None):
        """df_axpy's launches over `rows` rows: more rows than a launch
        stages go through launches in turn, each continuing the last one's
        result (the same chain, j in order), each from its slice of h (its
        coefficients of a gathered record); the first writes the folded
        record."""
        n, item = wh.shape[0], wh.element_size()
        r0 = 0
        while True:
            last = rows - r0 <= _AXPY_MAX_ROWS
            count = rows - r0 if last else _AXPY_MAX_ROWS
            plan = axpy_plan(n, count, item, norm and last)
            if gathered is None:
                h, fold = (hh[r0:], hl[r0:]), None
            else:
                g, h0, folded = gathered
                h, fold = (hh, hl), (g, h0 + r0, folded if r0 == 0 else None)
            out = self._axpy_launch(plan, wh, wl, *h, Vh[r0:], Vl[r0:], count,
                                    norm and last, fold)
            if last:
                return out
            wh, wl = out
            r0 += count

    def _axpy_launch(self, plan, wh, wl, hh, hl, Vh, Vl, rows, norm=False,
                     gathered=None):
        """df_axpy's launch over at most _AXPY_MAX_ROWS rows under `plan`
        (axpy_plan's, or another when measuring plans); the operands are
        checked by `axpy` or `axpy_gathered`.  With norm, the sum is a pair
        of 0-dim tensors on the card; its scratch is df_project's.
        `gathered`, (g, h_off, folded or None): h_j is coefficient h_off + j
        of the gathered record g (hh, hl its hi and lo views), folded in the
        launch; the whole record's sums into the (2, k) `folded`."""
        n = wh.shape[0]
        outh, outl = torch.empty_like(wh), torch.empty_like(wl)
        if norm:
            part, arrivals = self._stream_scratch(wh, 2 * plan.M, 1)
            s = torch.empty(2, dtype=wh.dtype, device=wh.device)
            scratch = (part.data_ptr(), part.numel(), arrivals.data_ptr(),
                       arrivals.numel(), s.data_ptr())
        else:
            scratch = (None, 0, None, 0, None)
        if gathered is None:
            fold = (0, 0, 0, 0, None, None)
        else:
            g, h_off, folded = gathered
            _check_ranks(g.buf.shape[0], plan.T)
            fold = (g.buf.stride(0), g.buf.shape[0], g.k, h_off,
                    *((None, None) if folded is None else
                      (folded[0].data_ptr(), folded[1].data_ptr())))
        self._launch("df_axpy", "df_axpy", wh, wh.data_ptr(), wl.data_ptr(),
                     hh.data_ptr(), hl.data_ptr(), Vh.data_ptr(),
                     Vl.data_ptr(), n, rows, plan.T, plan.C, plan.G, plan.L,
                     plan.U, plan.stage, *fold,
                     *scratch[:4], outh.data_ptr(), outl.data_ptr(),
                     scratch[4])
        self.axpy_forms["norm" if norm else "plain"] += 1
        if gathered is not None:
            self.gathered["df_axpy"] += 1
        return ((outh, outl), (s[0], s[1])) if norm else (outh, outl)

    def normalize(self, w, s, out, step=None):
        self._launch("df_normalize", "df_normalize", w[0],
                     *_normalize_args(w, s, out, step))
        if step is not None and isinstance(step.s2, Gathered):
            self.gathered["df_normalize"] += 1
        return out

    def basis_change(self, Vh, Vl, Qh, Ql, rows=None, out=None):
        _check(Vh, Vl, Qh, Ql, *(out or ()))
        m1, n = Vh.shape
        rows = m1 if rows is None else rows
        if Qh.shape != (m1, m1) or Ql.shape != (m1, m1):
            raise ValueError(f"df_basis_change: Q must be {(m1, m1)}")
        if not 1 <= rows <= m1 or (out is not None and any(
                o.dim() != 2 or o.shape[0] < rows or o.shape[1] != n
                for o in out)):
            raise ValueError(f"df_basis_change: rows={rows}, V {(m1, n)}")
        if 2 * m1 * Vh.element_size() > _BASIS_STAGE_BYTES:
            raise ValueError(
                f"df_basis_change takes the bases whose column of both words "
                f"fits {_BASIS_STAGE_BYTES} bytes of shared memory, not "
                f"{m1} rows")
        plan = basis_plan(m1, n, rows, Vh.element_size())
        shares_v = out is not None and any(
            o.untyped_storage().data_ptr() in (
                Vh.untyped_storage().data_ptr(),
                Vl.untyped_storage().data_ptr()) for o in out)
        if out is None or (shares_v and not plan.in_place):
            dst = (torch.empty((rows, n), dtype=Vh.dtype, device=Vh.device),
                   torch.empty((rows, n), dtype=Vh.dtype, device=Vh.device))
        else:
            dst = out
        self._basis_launch(plan, Vh, Vl, Qh, Ql, rows, dst)
        if out is None:
            return dst
        if dst is not out:
            out[0][:rows].copy_(dst[0])
            out[1][:rows].copy_(dst[1])
        return out[0][:rows], out[1][:rows]

    def _basis_launch(self, plan, Vh, Vl, Qh, Ql, rows, dst):
        """df_basis_change's launch under `plan` into the pair `dst` (not
        V unless plan.in_place); the operands are checked by
        `basis_change`."""
        m1, n = Vh.shape
        self._launch("df_basis_change", "df_basis_change", Vh, Vh.data_ptr(),
                     Vl.data_ptr(), Qh.data_ptr(), Ql.data_ptr(), m1, n, rows,
                     plan.R, plan.C, plan.W, dst[0].data_ptr(),
                     dst[1].data_ptr())
        return dst

    def stencil(self, xh, xl, coeffs, grid):
        _check(xh, xl)
        ny, nx = grid
        if xh.dim() != 1 or xh.numel() != ny * nx or xl.shape != xh.shape:
            raise ValueError(f"stencil5_df: x must be flat of {ny * nx}")
        return self._stencil_launch(
            stencil_plan(ny, nx, xh.element_size()).P, xh, xl, coeffs, grid)

    def _stencil_launch(self, P, xh, xl, coeffs, grid):
        """stencil5_df's launch with P points a thread (stencil_plan's, or
        another when measuring plans); the operands are checked by
        `stencil`."""
        yh, yl = torch.empty_like(xh), torch.empty_like(xl)
        self._launch("stencil5_df", "stencil5_df", xh, xh.data_ptr(),
                     xl.data_ptr(), yh.data_ptr(), yl.data_ptr(), *grid, P,
                     _coefficient_array(tuple(coeffs), xh.dtype))
        return yh, yl

    def rank_sum(self, hi, lo, acc=None):
        if acc is not None:
            _check(*acc)
        dtype, device = hi.dtype, hi.device
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"df_rank_sum takes float32 or float64, got {dtype}")
        P, k = hi.shape
        if (lo.shape != hi.shape or lo.dtype != dtype or lo.device != device
                or hi.stride() != lo.stride() or hi.stride(1) != 1
                or not 1 <= P <= _RANK_SUM_MAX_RANKS
                or any(t.shape != (k,) or t.dtype != dtype or t.device != device
                       for t in acc or ())):
            raise ValueError(
                f"df_rank_sum: (P, k) words of one dtype, device and row "
                f"stride, unit column stride, 1 <= P <= {_RANK_SUM_MAX_RANKS}, "
                f"acc of k; got {tuple(hi.shape)} and {tuple(lo.shape)}")
        out = torch.empty(2, k, dtype=dtype, device=device)
        ah, al = acc if acc is not None else (None, None)
        self._launch("df_rank_sum", "df_rank_sum", hi, hi.data_ptr(),
                     lo.data_ptr(), hi.stride(0), P, k, out[0].data_ptr(),
                     out[1].data_ptr(), None if ah is None else ah.data_ptr(),
                     None if al is None else al.data_ptr())
        return out[0], out[1]


def _normalize_args(w, s, out, step=None):
    """df_normalize's C arguments but the stream, after checking the
    operands: every tensor of one word dtype and device, contiguous; the
    step's shapes and column; a gathered s2's record of one part."""
    flat = [*w, *s, *out]
    gathered = step is not None and isinstance(step.s2, Gathered)
    if step is not None:
        s2 = (step.s2.buf,) if gathered else step.s2
        flat += [*step.r2, *step.w2, *s2, *step.h1, *step.c, *step.H,
                 step.flags]
    _check(*flat)
    n = w[0].numel()
    if (any(t.shape != (n,) for t in (*w, *out))
            or any(t.dim() != 0 for t in s)):
        raise ValueError("df_normalize: w and out must be flat of one length "
                         "and the sum two 0-dim words")
    ptrs = [t.data_ptr() for t in (*w, *s)]
    if step is None:
        return [*ptrs, *(None,) * 6, n, *(None,) * 4, 0, None, None, 0, 0,
                None, out[0].data_ptr(), out[1].data_ptr(), 0, 0]
    Hh, Hl = step.H
    m1, m = Hh.shape
    if gathered:
        g = step.s2
        _check_ranks(g.buf.shape[0])
        s2, s2_ld, ranks = (g.hi, g.lo), g.buf.stride(0), g.buf.shape[0]
        if g.k != 1 or g.buf.shape[1] != 2:
            raise ValueError("df_normalize: a gathered s2 is one sum")
    else:
        s2, s2_ld, ranks = step.s2, 0, 0
        if any(t.dim() != 0 for t in s2):
            raise ValueError("df_normalize: s2 must be two 0-dim words")
    if (any(t.shape != (n,) for t in step.w2)
            or any(t.dim() != 0 for t in step.r2)
            or any(t.shape != (m1,) for t in (*step.h1, *step.c))
            or Hl.shape != (m1, m) or step.flags.shape != (m,)
            or not 0 <= step.j < m or step.j + 1 >= m1):
        raise ValueError(f"df_normalize: a step j={step.j} of H "
                         f"{tuple(Hh.shape)} with w of {n}")
    col = step.j * Hh.element_size()
    return [*ptrs, *(t.data_ptr() for t in (*step.w2, *s2, *step.r2)),
            n, *(t.data_ptr() for t in (*step.h1, *step.c)), m1,
            Hh.data_ptr() + col, Hl.data_ptr() + col, m, step.j + 1,
            step.flags.data_ptr() + col, out[0].data_ptr(),
            out[1].data_ptr(), s2_ld, ranks]


@functools.lru_cache(maxsize=64)
def _coefficient_array(coeffs, dtype):
    """coefficient_words as the C array the kernel takes, made once."""
    return (ctypes.c_double * 15)(*coefficient_words(coeffs, dtype))


KERNEL = _DfKernel()


def _on_card(t, what):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {t.device}")
    return True


def df_project(Vh, Vl, wh, wl, rows, acc=None):
    """(ch, cl), length V.shape[0]: the double-word dot of each of the
    first `rows` rows of (Vh, Vl) with (wh, wl), zeros beyond.  With
    acc=(ah, al), also acc <- df_add(acc, c) in place (every row).  The
    sum over a row follows df32.df_sum's tree exactly."""
    if _on_card(Vh, "df_project"):
        return KERNEL.project(Vh, Vl, wh, wl, rows, acc)
    return df_project_plain(Vh, Vl, wh, wl, rows, acc)


def df_axpy(wh, wl, hh, hl, Vh, Vl, rows, norm=False):
    """w - sum_{j < rows} h_j V[j] in double word, j in order; new tensors.
    With norm=True, ((outh, outl), (sh, sl)): also the double-word sum of
    squares of the result, df32.df_sum(df_mul(out, out)), as 0-dim tensors
    (on the card, from the same launch)."""
    if _on_card(wh, "df_axpy"):
        return KERNEL.axpy(wh, wl, hh, hl, Vh, Vl, rows, norm)
    return df_axpy_plain(wh, wl, hh, hl, Vh, Vl, rows, norm)


def df_axpy_gathered(wh, wl, g, Vh, Vl, rows, norm=False):
    """df_axpy with its coefficients h the last part of the gathered record
    `g` (a `Gathered`: a row-sharded solve's partials), summed over the
    ranks inside the launch: (df_axpy's result, (sh, sl)), the second the
    record's k sums over the ranks, flat, the bits of df_rank_sum(g.hi,
    g.lo), for the kernels after it."""
    if _on_card(wh, "df_axpy"):
        return KERNEL.axpy_gathered(wh, wl, g, Vh, Vl, rows, norm)
    return df_axpy_gathered_plain(wh, wl, g, Vh, Vl, rows, norm)


def df_normalize(w, s, out, step=None):
    """out <- w / ||w|| in double word, ||w|| = df_sqrt(s) from w's sum of
    squares s (two 0-dim words on w's device), into the pair `out`.  With
    step (a DgksStep of step j): w is the first Gram-Schmidt pass's result
    and s its sum; the second pass is taken (its w, and h1 + c into H's
    column j) when ||w1|| < ETA ||r||, and the step breaks down when the
    norm is at most ETA times the norm before the last pass.  Then out is
    w unscaled, H[j+1, j] the norm all the same, flags[j] = 1.  Every
    decision is the host version's, on the card.  The step's s2 may be a
    `Gathered` record, summed over the ranks inside the launch."""
    if _on_card(w[0], "df_normalize"):
        return KERNEL.normalize(w, s, out, step)
    return df_normalize_plain(w, s, out, step)


def df_basis_change(Vh, Vl, Qh, Ql, rows=None, out=None):
    """(outh, outl) with out[i] = sum_j Q[j, i] V[j] in double word, j in
    order, for the first `rows` rows i (all by default): the basis change
    V <- Q^T V.  New tensors of `rows` rows, or the first `rows` rows of
    `out` (a pair; V itself for the change in place)."""
    if _on_card(Vh, "df_basis_change"):
        return KERNEL.basis_change(Vh, Vl, Qh, Ql, rows, out)
    return df_basis_change_plain(Vh, Vl, Qh, Ql, rows, out)


def stencil5_df(xh, xl, coeffs, grid):
    """The Dirichlet 5-point stencil on an (ny, nx) grid applied to the
    double-word vector (xh, xl); coeffs (center, west, east, north,
    south)."""
    if _on_card(xh, "stencil5_df"):
        return KERNEL.stencil(xh, xl, coeffs, grid)
    return stencil5_df_plain(xh, xl, coeffs, grid)


def df_rank_sum(hi, lo, acc=None):
    """(sh, sl), length k: the double-word sum over the P rows of the
    (P, k) pair (hi, lo), a row-sharded solve's gathered partials, by
    df32.df_sum's tree along the rows (P padded with zero pairs to a power
    of two, row r paired with r + P'/2).  The two may be views into one
    buffer with a common row stride.  With acc=(ah, al), also acc <-
    df_add(acc, sum) in place."""
    if _on_card(hi, "df_rank_sum"):
        return KERNEL.rank_sum(hi, lo, acc)
    return df_rank_sum_plain(hi, lo, acc)
