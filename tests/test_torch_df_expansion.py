"""The port's extended-precision expansion (ops/df_expansion.py), its
kernel wrappers' plain versions (ops/df.py) and the operators' matvec_df,
against the JAX package's ops/df_expansion.py and operators, in float32
words: bitwise, at a non-power-of-two n.

JAX's functions run op by op (`jax.disable_jit()`), for the reason given
in tests/test_torch_df32.py: compiled, XLA:CPU contracts the unpinned
low-order products of df_mul and df_scale into FMAs.  The compiled
expansion agrees with the port to 1e-13 in H (its low words move).

On the CPU every wrapper of ops/df.py takes its plain version; the CUDA
kernels are held bitwise to those plain versions by chip_smoke.py
(`df_kernel`).  The kernels' order of sums is checked here by emulating it
with the plain ops: df_project's thread, block and last-block levels
reproduce df32.df_sum's tree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_tpu.models.operators import (
    DiaOperator as JDia,
    Stencil5Operator as JStencil,
)
from arnoldimethod_tpu.ops import df_expansion as jde
from arnoldimethod_torch import _device
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch.models.operators import (
    DenseOperator,
    DiaOperator,
    Stencil5Operator,
)
from arnoldimethod_torch.ops import df, df32
from arnoldimethod_torch.ops import df_expansion as tde
from arnoldimethod_torch.ops.df32 import ETA
from arnoldimethod_torch.ops.expansion import LOWSYNC

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


N = 1000
F32 = np.float32


def _pair(rng, *shape):
    """A normalized float32 double word (|lo| <= ulp(hi) / 2, as every
    double word the solver makes): the two roundings of a float64."""
    x = rng.standard_normal(shape)
    hi = x.astype(F32)
    return hi, (x - hi).astype(F32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same(jax_out, port_out):
    for a, b in zip(jax_out, port_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -- the kernels' order of sums --------------------------------------------


def _halve(xh, xl, keep, levels):
    """df32.df_sum's halving levels along axis 0 while longer than `keep`
    and `levels(length)` holds: the lower half is the left operand."""
    while xh.shape[0] > keep and levels(xh.shape[0]):
        half = xh.shape[0] // 2
        xh, xl = df32.df_add(xh[:half], xl[:half], xh[half:], xl[half:])
    return xh, xl


def _kernel_order_sum(xh, xl, plan):
    """df_project's grouping for one row (csrc/df.cu project_kernel),
    emulated with the plain ops.  The padded index splits, top bit to
    bottom, into i = h (T G) + wt (G C) + b C + c; thread tid = wt C + c of
    block b holds the elements h."""
    T, C, G, L = plan.T, plan.C, plan.G, plan.L
    n = xh.shape[-1]
    N = 1 << max(0, n - 1).bit_length()
    assert N == (T << L) * G
    x = [torch.nn.functional.pad(v, (0, N - n)).reshape(1 << L, T // C, G, C)
         for v in (xh, xl)]
    # 1. Each thread: the tree over its 2^L elements, in registers.
    x = _halve(*x, 1, lambda _: True)
    # 2. Each block: its T values a[tid] down to C, the levels with half >=
    #    32 in shared memory, then warp shuffles.
    x = [v[0].permute(0, 2, 1).reshape(T, G) for v in x]
    x = _halve(*x, C, lambda ln: ln // 2 >= 32)
    x = _halve(*x, C, lambda _: True)
    # 3. The last block: partial b C + c of each block, down to one; levels
    #    in device memory while the row outgrows the stage, then shared
    #    memory, then shuffles.
    x = [v.t().reshape(G * C) for v in x]
    x = _halve(*x, 1, lambda ln: ln > plan.stage)
    x = _halve(*x, 1, lambda ln: ln // 2 >= 32)
    ph, pl = _halve(*x, 1, lambda _: True)
    return ph[0], pl[0]


def _plan(n, T, C, L):
    """A hand-made launch of one row (the grid follows from n)."""
    N = 1 << max(0, n - 1).bit_length()
    G = N // (T << L)
    return df.ProjectPlan("one_row", T, C, G, L, min(G * C, 1024))


def _plans(n):
    """project_plan's launches at 1, 7 and 60 rows in both words, and hand
    plans with other block widths, sector runs and folds."""
    plans = {df.project_plan(n, rows, item) for rows in (1, 7, 60)
             for item in (4, 8)}
    N = 1 << max(0, n - 1).bit_length()
    for T, C, L in ((32, 8, 2), (64, 4, 3), (256, 8, 4), (2, 2, 0),
                    (256, 32, 3)):
        if C <= T and (T << L) <= N:
            plans.add(_plan(n, T, C, L))
    return sorted(plans)


@pytest.mark.parametrize("n", [1, 5, 64, 1000, 1024, 3000])
def test_kernel_order_of_sums_is_df_sums_tree(n):
    rng = np.random.default_rng(n)
    xh, xl = _t(*_pair(rng, n))
    want = df32.df_sum(xh, xl)
    for plan in _plans(n):
        got = _kernel_order_sum(xh, xl, plan)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), plan


@pytest.mark.parametrize("n,rows", [(65536, 1), (65536, 60), (1 << 20, 1),
                                    (1 << 20, 60)])
def test_kernel_order_of_sums_at_the_main_path_plans(n, rows):
    """The plans of config 3 (n = 65,536) and of 1,048,576 rows, the
    first levels in device memory among them (60 rows at 1M)."""
    rng = np.random.default_rng(n + rows)
    xh, xl = _t(*_pair(rng, n))
    want = df32.df_sum(xh, xl)
    for item in (4, 8):
        plan = df.project_plan(n, rows, item)
        got = _kernel_order_sum(xh, xl, plan)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), plan


@pytest.mark.parametrize("rows", [1, 2, 7, 60])
@pytest.mark.parametrize("n", [1, 2, 100, 1000, 4096, 1 << 16, 1 << 20,
                               1021 * 1000, 1 << 24])
def test_project_plan(n, rows):
    N = 1 << max(0, n - 1).bit_length()
    for item in (4, 8):
        p = df.project_plan(n, rows, item)
        assert p.form == ("one_row" if rows == 1 else "full")
        assert p.T & (p.T - 1) == 0 and 1 <= p.T <= 256
        assert p.C & (p.C - 1) == 0 and p.C <= p.T
        assert p.C * item == (32 if rows == 1 else 128) or p.C == p.T
        assert (p.T << p.L) * p.G == N
        assert p.M & (p.M - 1) == 0 and p.M == p.G * p.C <= N
        fold = 4 if rows == 1 else 3
        assert 0 <= p.L <= fold
        assert p.stage & (p.stage - 1) == 0 and p.stage <= p.M
        assert 2 * item * max(p.T, p.stage) <= 48 * 1024
        # The longest fold that keeps 64 blocks where n and rows allow it,
        # else the widest grid; 132 blocks or more at the main path's
        # 60-row shapes.
        blocks = p.G * rows
        if N // p.T * rows < 64:
            assert p.L == 0
        else:
            assert blocks >= 64 and (p.L == fold or blocks < 128)
        if rows == 60 and n >= 1 << 16:
            assert blocks >= 132


# -- plain versions of the kernels against JAX -----------------------------


@pytest.fixture(scope="module")
def basis():
    rng = np.random.default_rng(0)
    Vh, Vl = _pair(rng, 7, N)
    wh, wl = _pair(rng, N)
    Qh, Ql = _pair(rng, 7, 7)
    return Vh, Vl, wh, wl, Qh, Ql


@pytest.mark.parametrize("rows", [0, 1, 4, 7])
def test_project_and_axpy_match_jax_masked_project(basis, rows):
    """df_project + df_axpy over the leading rows = JAX's masked project
    (both of its passes, the second accumulating into h)."""
    Vh, Vl, wh, wl, _, _ = basis
    mask = jnp.arange(7) < rows
    with jax.disable_jit():
        (jh, jl), (jwh, jwl) = jde._df_masked_project(*_j(Vh, Vl, wh, wl), mask)
        (jch, jcl), (jw2h, jw2l) = jde._df_masked_project(
            *_j(Vh, Vl), jwh, jwl, mask)
        jah, jal = jde.df32.df_add(jh, jl, jch, jcl)
    tVh, tVl, twh, twl = _t(Vh, Vl, wh, wl)
    h = df.df_project(tVh, tVl, twh, twl, rows)
    w = df.df_axpy(twh, twl, *h, tVh, tVl, rows)
    _same((jh, jl, jwh, jwl), (*h, *w))
    acc = (h[0].clone(), h[1].clone())
    c = df.df_project(tVh, tVl, *w, rows, acc=acc)
    w2 = df.df_axpy(*w, *c, tVh, tVl, rows)
    _same((jch, jcl, jw2h, jw2l, jah, jal), (*c, *w2, *acc))


def _dgks_basis(second):
    """Seven orthonormal rows (float64 split into two words) and a w that
    the first pass over rows 0..4 shrinks below ETA of its norm (w mostly
    in their span: the second pass runs) or not (mostly outside)."""
    rng = np.random.default_rng(9)
    Q = np.linalg.qr(rng.standard_normal((N, 7)))[0].T
    inside, outside = (1.0, 0.01) if second else (0.01, 1.0)
    w = Q[:5].T @ rng.standard_normal(5) * inside + (
        rng.standard_normal(N) * outside)
    hi, whi = Q.astype(F32), w.astype(F32)
    return hi, (Q - hi).astype(F32), whi, (w - whi).astype(F32)


@pytest.mark.parametrize("second", [True, False])
def test_normalize_matches_jax(second):
    """df_normalize_plain's step form from the device sums of both passes:
    the normalized w, H's column (h, and the norm at row j + 1) and the
    breakdown flag of JAX's _df_dgks and _df_normalize, bitwise, with the
    second pass taken and not; the one-sum form is JAX's _df_normalize."""
    Vh, Vl, wh, wl = _dgks_basis(second)
    j = 4
    with jax.disable_jit():
        jw2h, jw2l, jhh, jhl, jwn, jref = jde._df_dgks(
            *_j(Vh, Vl, wh, wl), jnp.arange(7) <= j)
        (jsh, jsl), (jnh, jnl) = jde._df_normalize(jw2h, jw2l)
        jbreak = bool(jwn <= ETA * jref)
        (j1h, j1l), _ = jde._df_normalize(*_j(wh, wl))
    tVh, tVl, twh, twl = _t(Vh, Vl, wh, wl)
    assert tde._dgks(tVh, tVl, twh, twl, j + 1)[-1] == (2 if second else 1)
    r2 = tde._sumsq(twh, twl)
    h1, w1, s1 = tde._masked_project(tVh, tVl, twh, twl, j + 1, norm=True)
    c, w2, s2 = tde._masked_project(tVh, tVl, *w1, j + 1, norm=True)
    Hh, Hl = torch.full((7, 6), 7.0), torch.full((7, 6), 7.0)
    flags = torch.full((6,), 7.0)
    out = (torch.empty(N), torch.empty(N))
    df.df_normalize(w1, s1, out,
                    df.DgksStep(r2, w2, s2, h1, c, (Hh, Hl), j, flags))
    rows = np.arange(7)
    _same((jsh, jsl, np.where(rows == j + 1, jnh, jhh),
           np.where(rows == j + 1, jnl, jhl)), (*out, Hh[:, j], Hl[:, j]))
    assert not jbreak and flags[j] == 0
    assert (Hh[:, :j] == 7).all() and (flags[:j] == 7).all()
    # The one-sum form: w / ||w|| from w's sum.
    df.df_normalize((twh, twl), tde._sumsq(twh, twl), out)
    _same((j1h, j1l), out)


def test_host_scalar_ops_equal_the_tensor_ops():
    """df_sqrt and df_inv on numpy scalars (the host side of the stepwise
    solve) give the bits of the same ops on 0-dim tensors and on a vector
    (df_normalize's plain version), in both word types, over 4,000 sums
    across six decades: every root correctly rounded on both sides."""
    rng = np.random.default_rng(10)
    for dtype in (np.float32, np.float64):
        x = rng.standard_normal(4000) ** 2 * 10.0 ** rng.uniform(-3, 3, 4000)
        h = x.astype(dtype)
        lo = ((x - h.astype(np.float64)) if dtype == np.float32
              else x * 2.0 ** -60).astype(dtype)
        for fn in (df32.df_sqrt, df32.df_inv):
            vec = fn(*_t(h, lo))
            for i in range(0, 4000, 97):
                b = fn(*_t(h[i], lo[i]))
                _same([np.asarray(v) for v in b], [v[i] for v in vec])
            host = [fn(a, b) for a, b in zip(h, lo)]
            assert all(type(v) is dtype for v in host[0])
            _same([np.array([v[k] for v in host]) for k in (0, 1)], vec)


def test_basis_change_matches_jax(basis):
    Vh, Vl, _, _, Qh, Ql = basis
    with jax.disable_jit():
        jout = jde.df_apply_basis_change(*_j(Vh, Vl, Qh, Ql))
    tVh, tVl, tQh, tQl = _t(Vh, Vl, Qh, Ql)
    _same(jout, df.df_basis_change(tVh, tVl, tQh, tQl))
    tde.df_apply_basis_change(tVh, tVl, tQh, tQl)  # in place
    _same(jout, (tVh, tVl))


@pytest.mark.parametrize("rows", [1, 3, 6, 7])
def test_basis_change_rows_window(basis, rows):
    """df_basis_change(rows=r): the first r rows of the full result and of
    JAX's, into new tensors or in place (rows past r untouched)."""
    Vh, Vl, _, _, Qh, Ql = basis
    with jax.disable_jit():
        jout = jde.df_apply_basis_change(*_j(Vh, Vl, Qh, Ql))
    tVh, tVl, tQh, tQl = _t(Vh, Vl, Qh, Ql)
    got = df.df_basis_change(tVh, tVl, tQh, tQl, rows)
    assert got[0].shape == (rows, N)
    _same([np.asarray(j)[:rows] for j in jout], got)
    full = df.df_basis_change_plain(tVh, tVl, tQh, tQl)
    _same([f[:rows].numpy() for f in full], got)
    tde.df_apply_basis_change(tVh, tVl, tQh, tQl, rows)
    _same([np.asarray(j)[:rows] for j in jout], (tVh[:rows], tVl[:rows]))
    _same((Vh[rows:], Vl[rows:]), (tVh[rows:], tVl[rows:]))


@pytest.mark.parametrize("m1,n", [(1, 1), (7, 1000), (31, 65536),
                                  (61, 65536), (61, 1 << 20), (65, 1000),
                                  (200, 4096), (3072, 10), (6144, 3)])
def test_basis_plan(m1, n):
    """Every tile of both words: one Q record a thread a stage, two stages
    within 48 KB, the grid covering every row and column, and one slab (the
    change in place) wherever rows <= 64."""
    for item in (4, 8):
        if 2 * m1 * item > df._BASIS_STAGE_BYTES:
            continue
        for rows in sorted({1, (m1 + 1) // 2, m1}):
            default = df.basis_plan(m1, n, rows, item)
            assert (default.R, default.C) == df._BASIS_TILES[item][0] == (
                (8, 2) if item == 4 else (4, 2))
            for tile in df._BASIS_TILES[item]:
                p = df.basis_plan(m1, n, rows, item, tile)
                assert (p.R, p.C) == tile and p.C * item <= 16
                assert p.J * p.R == 32 and 1 <= p.W * p.R <= 64
                assert p.smem <= 48 * 1024
                assert p.slabs * p.W * p.R >= rows > (p.slabs - 1) * p.W * p.R
                assert p.blocks * 32 * p.C >= n > (p.blocks - 1) * 32 * p.C
                assert p.slabs <= 65535
                assert p.in_place == (p.slabs == 1)
                if rows <= 64:
                    assert p.in_place


@pytest.mark.parametrize("ny,nx", [(1, 1), (3, 9), (64, 64), (256, 256),
                                   (1021, 1000), (1024, 1024), (4096, 4096),
                                   (1, 100000)])
def test_stencil_plan(ny, nx):
    """Up to four points a thread in float32 words and two in float64, as
    many as keep 264 tiles (two a SM of an H100) where the grid has them;
    the tiles cover the grid, a block each."""
    for item in (4, 8):
        p = df.stencil_plan(ny, nx, item)
        assert p.P in (1, 2, 4) and p.P * item <= 16
        cols = -(-nx // 32)
        assert p.blocks == cols * -(-ny // (4 * p.P))
        if p.P > 1:
            assert p.blocks >= 264
        if 2 * p.P * item <= 16:
            assert cols * -(-ny // (8 * p.P)) < 264
        if (ny, nx) == (256, 256):
            assert p.blocks >= 264  # at least two blocks on every SM


def test_coefficient_words_are_the_kernel_splits():
    """The stencil's host coefficient words: each coefficient rounded to
    the word, then df32.split's halves, the values a split of a tensor of
    the word type gives."""
    for dtype in (torch.float32, torch.float64):
        words = df.coefficient_words(COEFFS, dtype)
        c = torch.tensor(COEFFS, dtype=dtype)
        hi, lo = df32.split(c)
        assert words == [*c.tolist(), *hi.tolist(), *lo.tolist()]


def _dia_pair(rng):
    offsets = (-31, -1, 0, 2, 7)
    diags = rng.standard_normal((len(offsets), N)).astype(F32)
    return JDia(jnp.asarray(diags), offsets, (N, N)), DiaOperator(diags, offsets, (N, N))


COEFFS = (4.3, -1.2, -0.8, -1.0, -1.1)


@pytest.mark.parametrize("case", ["laplacian_1d", "dia5", "stencil", "stencil_plain",
                                  "stencil_periodic"])
def test_matvec_df_matches_jax(case):
    """DiaOperator and Stencil5Operator matvec_df, bitwise; the stencil on a
    25 x 40 grid (Dirichlet through ops.df.stencil5_df, use_pallas=False,
    periodic)."""
    rng = np.random.default_rng(4)
    if case == "laplacian_1d":
        jop, top = jp.laplacian_1d(N, dtype=F32), tp.laplacian_1d(N, dtype=torch.float32)
    elif case == "dia5":
        jop, top = _dia_pair(rng)
    else:
        kw = {"stencil": {}, "stencil_plain": {"use_pallas": False},
              "stencil_periodic": {"boundary": "periodic"}}[case]
        jop = JStencil(COEFFS, (25, 40), dtype=jnp.float32, **kw)
        top = Stencil5Operator(COEFFS, (25, 40), dtype=torch.float32, **kw)
    xh, xl = _pair(rng, N)
    with jax.disable_jit():
        jy = jop.matvec_df(*_j(xh, xl))
    _same(jy, top.matvec_df(*_t(xh, xl)))


def test_stencil_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    xh, xl = _t(*_pair(rng, 21 * 10))
    grid = (21, 10)
    got = df.stencil5_df(xh, xl, COEFFS, grid)
    _same(df.stencil5_df_plain(xh, xl, COEFFS, grid), got)


# -- the expansion against JAX ---------------------------------------------


def _start(n, m, seed=1):
    v = np.random.default_rng(seed).standard_normal(n).astype(F32)
    V0 = np.zeros((m + 1, n), F32)
    V0[0] = v / np.linalg.norm(v)
    return V0


def _jax_start(V0):
    return jde.df_set_initial_vector(jnp.asarray(V0), jnp.zeros_like(jnp.asarray(V0)),
                                     jnp.asarray(V0[0]))


def _port_start(V0):
    Vh, Vl = torch.from_numpy(V0.copy()), torch.zeros(V0.shape)
    tde.df_set_initial_vector(Vh, Vl, Vh[0])
    return Vh, Vl


@pytest.mark.parametrize("case", ["laplacian_1d", "stencil"])
def test_expand_range_matches_jax(case):
    m = 6
    if case == "laplacian_1d":
        jop, top = jp.laplacian_1d(N, dtype=F32), tp.laplacian_1d(N, dtype=torch.float32)
    else:
        jop = JStencil(COEFFS, (25, 40), dtype=jnp.float32)
        top = Stencil5Operator(COEFFS, (25, 40), dtype=torch.float32)
    V0 = _start(N, m)
    Vh, Vl = _port_start(V0)
    Hh, Hl = torch.zeros(m + 1, m), torch.zeros(m + 1, m)
    (wh, wl), reads = tde.df_expand_range(top, Vh, Vl, Hh, Hl, 0, m,
                                          torch.Generator())
    assert reads == 1 and bool((Hh.diagonal(-1) != 0).all())
    _same((wh, wl), (Hh, Hl))
    with jax.disable_jit():
        jV, jVl = _jax_start(V0)
        zero = jnp.zeros((m + 1, m), jnp.float32)
        jout = jde.df_expand_range(jop, jV, jVl, zero, zero, 0, m,
                                   jax.random.PRNGKey(0))
    _same(jout, (Vh, Vl, Hh, Hl))
    if case != "laplacian_1d":
        return
    # Compiled, JAX's low words move by its FMA contractions: within 1e-13.
    jV, jVl = _jax_start(V0)
    zero = jnp.zeros((m + 1, m), jnp.float32)
    jc = jde.df_expand_range(jop, jV, jVl, zero, jnp.zeros_like(zero), 0, m,
                             jax.random.PRNGKey(0))
    Hj = np.asarray(jc[2], np.float64) + np.asarray(jc[3], np.float64)
    Ht = Hh.double().numpy() + Hl.double().numpy()
    assert np.abs(Hj - Ht).max() <= 1e-13


def _driver_qbig(m, k, purge, seed):
    """The restart's basis-change matrix as driver.py builds it: identity,
    columns [purge, k) from an orthogonal Q on rows [purge, m), column k
    taking the old row m (the next-vector slot)."""
    Q = np.linalg.qr(np.random.default_rng(seed).standard_normal((m, m)))[0]
    Qbig = np.eye(m + 1)
    Qbig[:, purge:k] = 0
    Qbig[purge:m, purge:k] = Q[purge:m, purge:k]
    Qbig[:, k] = 0
    Qbig[m, k] = 1
    return Qbig


def test_truncate_and_expand_matches_jax():
    """A restart's device step: basis change by an orthogonal (m+1) matrix
    split into two words, then expansion from k = 3; then the same with a
    Qbig built as the driver builds it (k < m).  The port computes only
    rows 0..k of the change (the expansion rewrites the rest); V, H and
    their low words end bitwise equal to JAX's in every row."""
    m, k = 6, 3
    jop, top = jp.laplacian_1d(N, dtype=F32), tp.laplacian_1d(N, dtype=torch.float32)
    orthogonal = np.linalg.qr(
        np.random.default_rng(2).standard_normal((m + 1, m + 1)))[0]
    for Q in (orthogonal, _driver_qbig(m, k, 1, 3)):
        V0 = _start(N, m)
        Vh, Vl = _port_start(V0)
        Hh, Hl = torch.zeros(m + 1, m), torch.zeros(m + 1, m)
        tde.df_expand_range(top, Vh, Vl, Hh, Hl, 0, m, torch.Generator())
        Qh, Ql = tde.split_f64(Q, torch.float32, "cpu")
        with jax.disable_jit():
            jQh, jQl = jde.split_f64(Q, np.float32)
            args = [jnp.asarray(t.numpy()) for t in (Vh, Vl, Hh, Hl)]
            jout = jde.df_truncate_and_expand(jop, *args, jQh, jQl, k, m,
                                              jax.random.PRNGKey(0))
        _same((jQh, jQl), (Qh, Ql))
        tde.df_truncate_and_expand(top, Vh, Vl, Hh, Hl, Qh, Ql, k, m,
                                   torch.Generator())
        _same(jout, (Vh, Vl, Hh, Hl))


# -- the range with no host read against the stepwise one -------------------


INTS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _bits(*pairs):
    """Equal bits (signed zeros and NaNs included) of each pair."""
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a.view(INTS[a.dtype]), b.view(INTS[b.dtype]))
               for a, b in pairs)


def _operator(case, dtype):
    word = torch.empty(0, dtype=dtype).numpy().dtype
    if case == "laplacian_1d":
        return tp.laplacian_1d(N, dtype=dtype), N
    if case == "stencil":
        return Stencil5Operator(COEFFS, (25, 40), dtype=dtype), N
    if case == "diag_e1":  # tests/test_torch_extended.py's exact closure
        diag = np.linspace(1.0, 4.0, 32).astype(word)
        return DiaOperator(diag[None, :], (0,), (32, 32)), 32
    if case == "zero":
        return DiaOperator(np.zeros((1, 12), word), (0,), (12, 12)), 12
    # A 3-cycle and a 7-cycle: from e_0 the Krylov space closes at step 2.
    P = np.zeros((10, 10), word)
    for c in (list(range(3)), list(range(3, 10))):
        P[c[1:] + c[:1], c] = 1.0
    return DenseOperator(P), 10


def _both_ranges(case, dtype, m, restart=None):
    """One expansion of m steps by df_expand_range_stepwise and by
    df_expand_range from one start and generator seed, then, with restart
    = (Q, k), a restart's step by each (the basis change, then steps
    k..m-1).  Returns both (Vh, Vl, Hh, Hl, the generator's state, what
    the last range returned)."""
    top, n = _operator(case, dtype)
    v = np.random.default_rng(1).standard_normal(n)
    if case in ("diag_e1", "cycles"):
        v = np.eye(n)[0]
    out = []
    for deferred in (False, True):
        Vh = torch.zeros(m + 1, n, dtype=dtype)
        Vl = torch.zeros_like(Vh)
        tde.df_set_initial_vector(Vh, Vl, torch.from_numpy(v))
        Hh = torch.zeros(m + 1, m, dtype=dtype)
        Hl = torch.zeros_like(Hh)
        gen = torch.Generator().manual_seed(3)
        expand = (tde.df_expand_range if deferred
                  else tde.df_expand_range_stepwise)
        got = expand(top, Vh, Vl, Hh, Hl, 0, m, gen)
        if restart is not None:
            Q, k = restart
            Qh, Ql = tde.split_f64(Q, dtype, "cpu")
            if deferred:
                got = tde.df_truncate_and_expand(top, Vh, Vl, Hh, Hl, Qh, Ql,
                                                 k, m, gen)
            else:
                tde.df_apply_basis_change(Vh, Vl, Qh, Ql)
                got = tde.df_expand_range_stepwise(top, Vh, Vl, Hh, Hl, k, m,
                                                   gen)
        out.append((Vh, Vl, Hh, Hl, gen.get_state(), got))
    return out


WORDS = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", WORDS)
@pytest.mark.parametrize("case", ["laplacian_1d", "stencil"])
def test_range_is_the_stepwise_range(case, dtype):
    """No breakdown: the same V and H pairs bit for bit, the generator
    untouched by both, one read, and the host words are H's."""
    m = 8
    (V1, L1, H1, G1, g1, reads1), (V2, L2, H2, G2, g2, got) = _both_ranges(
        case, dtype, m)
    assert _bits((V1, V2), (L1, L2), (H1, H2), (G1, G2))
    assert torch.equal(g1, g2)
    (hh, hl), reads = got
    assert reads == 1 and m <= reads1 <= 2 * m
    assert bool((H2.diagonal(-1) != 0).all())
    assert _bits((torch.from_numpy(hh), H2), (torch.from_numpy(hl), G2))


@pytest.mark.parametrize("dtype", WORDS)
def test_truncate_and_expand_is_the_stepwise_one(dtype):
    """A restart's step after the first range, with a Qbig built as the
    driver builds it: bit for bit the stepwise change and expansion."""
    m, k = 8, 3
    (V1, L1, H1, G1, g1, _), (V2, L2, H2, G2, g2, got) = _both_ranges(
        "laplacian_1d", dtype, m, (_driver_qbig(m, k, 1, 3), k))
    assert _bits((V1, V2), (L1, L2), (H1, H2), (G1, G2))
    assert torch.equal(g1, g2)
    assert got[1] == 1 and bool((H2.diagonal(-1) != 0).all())


@pytest.mark.parametrize("dtype", WORDS)
@pytest.mark.parametrize("case,m,want", [("diag_e1", 6, [0]),
                                         ("cycles", 8, [2]),
                                         ("zero", 5, [0, 1, 2, 3, 4])])
def test_breakdown_rolls_back_to_the_stepwise_result(case, m, want, dtype):
    """An exact closure at the first step (an eigenvector start), one in
    mid-range (step 2 of a permutation's 3-cycle) and a zero operator
    (every step): the steps after each breakdown run again; V, H and the
    generator end bitwise the stepwise version's, one rollback and one
    read more a breakdown (none for one at the range's last step), and
    every row stays finite."""
    LOWSYNC.rollbacks = LOWSYNC.discarded_matvecs = 0
    (V1, L1, H1, G1, g1, _), (V2, L2, H2, G2, g2, got) = _both_ranges(
        case, dtype, m)
    assert _bits((V1, V2), (L1, L2), (H1, H2), (G1, G2))
    assert torch.equal(g1, g2)
    (hh, hl), reads = got
    assert [j for j in range(m) if H2[j + 1, j] == 0] == want
    assert LOWSYNC.rollbacks == len(want)
    assert LOWSYNC.discarded_matvecs == sum(m - 1 - j for j in want)
    assert reads == 1 + len(want) - (m - 1 in want)
    assert _bits((torch.from_numpy(hh), H2), (torch.from_numpy(hl), G2))
    assert bool(torch.isfinite(V2).all() and torch.isfinite(L2).all())


def test_reorthogonalize_row_matches_jax():
    m, j = 6, 3
    rng = np.random.default_rng(6)
    V0 = np.linalg.qr(rng.standard_normal((N, m + 1)))[0].T.astype(F32)
    Vh, Vl = torch.from_numpy(V0.copy()), torch.zeros(m + 1, N)
    tde.df_reorthogonalize_row(Vh, Vl, j)
    with jax.disable_jit():
        jout = jde.df_reorthogonalize_row(jnp.asarray(V0), jnp.zeros((m + 1, N), jnp.float32), j)
    _same(jout, (Vh, Vl))


def test_random_vector_is_orthonormal_in_double_word():
    """A warm start's fresh row: orthogonal to the rows before it and of
    unit norm, both at the double-word level (float32 words)."""
    m, j = 6, 3
    rng = np.random.default_rng(7)
    V0 = np.linalg.qr(rng.standard_normal((N, m + 1)))[0].T.astype(F32)
    Vh, Vl = torch.from_numpy(V0.copy()), torch.zeros(m + 1, N)
    for i in range(j):
        tde.df_reorthogonalize_row(Vh, Vl, i)
    tde.df_set_random_vector(Vh, Vl, j, torch.Generator().manual_seed(3))
    V = Vh[: j + 1].double() + Vl[: j + 1].double()
    G = (V @ V.T).numpy()
    assert np.abs(G - np.eye(j + 1)).max() <= 1e-13


def test_split_f64():
    Q = np.random.default_rng(8).standard_normal((5, 5))
    hi, lo = tde.split_f64(Q, torch.float32, "cpu")
    assert hi.dtype == lo.dtype == torch.float32
    assert np.abs(hi.double().numpy() + lo.double().numpy() - Q).max() <= 1e-14


# -- the kernel wrappers ----------------------------------------------------


def test_kernel_wrappers_reject_bad_input():
    """The checks run before the kernel is built, so they hold here."""
    K = df._DfKernel()
    x = torch.zeros(8, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or float64"):
        K.project(x[None], x[None], x, x, 1)
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="share dtype"):
        K.axpy(v, v.double(), v, v, v[None], v[None], 1)
    s = (torch.zeros(()), torch.zeros(()))
    with pytest.raises(ValueError, match="contiguous"):
        K.normalize((torch.zeros(16)[::2], torch.zeros(8)), s, (v, v))
    with pytest.raises(ValueError, match="flat of one length"):
        K.normalize((v, v), s, (v, torch.zeros(9)))
    H = torch.zeros(4, 3)
    step = df.DgksStep(s, (v, v), s, (torch.zeros(4),) * 2,
                       (torch.zeros(4),) * 2, (H, H), 3, torch.zeros(3))
    with pytest.raises(ValueError, match="a step j=3"):
        K.normalize((v, v), s, (v, v), step)
    with pytest.raises(ValueError, match="a step j=2"):
        K.normalize((v, v), s, (v, v), step._replace(j=2, c=(v, v)))
    with pytest.raises(ValueError, match="rows"):
        K.project(v[None], v[None], v, v, 2)
    with pytest.raises(ValueError, match="Q must be"):
        K.basis_change(v[None], v[None], torch.zeros(2, 2), torch.zeros(2, 2))
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(7000, 1, dtype=torch.float64)
        K.basis_change(big, big, torch.zeros(7000, 7000, dtype=torch.float64),
                       torch.zeros(7000, 7000, dtype=torch.float64))
    with pytest.raises(ValueError, match="flat"):
        K.stencil(v, v, COEFFS, (3, 3))
    Q = torch.zeros(2, 2)
    V2 = torch.zeros(2, 8)
    for rows in (0, 3):
        with pytest.raises(ValueError, match="rows"):
            K.basis_change(V2, V2, Q, Q, rows)
    with pytest.raises(ValueError, match="rows"):
        K.basis_change(V2, V2, Q, Q, 2, out=(torch.zeros(1, 8),) * 2)


def test_truncate_computes_only_the_kept_rows(monkeypatch):
    """A restart asks for rows 0..k of the change; the final change (every
    row) and an expansion that stops short of the last row ask for all."""
    seen = []
    real = df.df_basis_change

    def spy(Vh, Vl, Qh, Ql, rows=None, out=None):
        seen.append(rows)
        return real(Vh, Vl, Qh, Ql, rows, out)

    monkeypatch.setattr(df, "df_basis_change", spy)
    m, k = 6, 3
    top = tp.laplacian_1d(N, dtype=torch.float32)
    Vh, Vl = _port_start(_start(N, m))
    Hh, Hl = torch.zeros(m + 1, m), torch.zeros(m + 1, m)
    eye = tde.split_f64(np.eye(m + 1), torch.float32, "cpu")
    tde.df_expand_range(top, Vh, Vl, Hh, Hl, 0, m, torch.Generator())
    tde.df_truncate_and_expand(top, Vh, Vl, Hh, Hl, *eye, k, m,
                               torch.Generator())
    tde.df_truncate_and_expand(top, Vh, Vl, Hh, Hl, *eye, k, m - 1,
                               torch.Generator())
    tde.df_apply_basis_change(Vh, Vl, *eye)
    assert seen == [k + 1, None, None]


def test_project_scratch_is_kept_and_grown_by_doubling():
    """df_project's partials and zeroed arrival counters are reused across
    calls on one stream; an outgrown buffer stays referenced (a captured
    CUDA graph may still use it)."""
    K = df._DfKernel()
    like = torch.zeros(1, dtype=torch.float64)
    part, arrivals = K._project_scratch(like, 100, 3, stream=7)
    assert part.numel() == 100 and part.dtype == torch.float64
    assert arrivals.dtype == torch.int32 and torch.equal(
        arrivals, torch.zeros(3, dtype=torch.int32))
    assert K._project_scratch(like, 60, 2, stream=7) == (part, arrivals)
    bigger, more = K._project_scratch(like, 150, 7, stream=7)
    assert bigger.numel() == 200 and more.numel() == 7
    assert K._retired[0] is part and K._retired[1] is arrivals
    other, _ = K._project_scratch(like.float(), 10, 1, stream=7)
    assert other.dtype == torch.float32 and bigger.numel() == 200


def test_project_scratch_is_kept_per_stream():
    """Two streams never share df_project's scratch; a call under graph
    capture takes its stream's scratch when it is large enough, else
    zeroed buffers of its own that are not kept."""
    K = df._DfKernel()
    like = torch.zeros(1)
    one = K._project_scratch(like, 100, 3, stream=1)
    two = K._project_scratch(like, 100, 3, stream=2)
    assert all(a is not b for a, b in zip(one, two))
    assert sorted(k[2] for k in K._scratch) == [1, 2]
    assert K._project_scratch(like, 50, 3, stream=2, capturing=True) == two
    part, arrivals = K._project_scratch(like, 400, 5, stream=2, capturing=True)
    assert part.numel() == 400 and torch.equal(
        arrivals, torch.zeros(5, dtype=torch.int32))
    assert K._scratch[(like.device, like.dtype, 2)] == two and not K._retired
    fresh = K._project_scratch(like, 10, 1, stream=3, capturing=True)
    assert fresh[0].numel() == 10 and len(K._scratch) == 2


def test_non_cpu_tensor_never_takes_the_plain_version():
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        df.df_axpy(v, v, v, v, v[None], v[None], 1)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        df._DfKernel().load()


def test_launch_counts_start_at_zero_and_plain_does_not_count():
    assert df._DfKernel().launches == dict.fromkeys(
        ("df_project", "df_axpy", "df_normalize", "df_basis_change",
         "stencil5_df"), 0)
    assert df._DfKernel().project_forms == {"one_row": 0, "full": 0}
    assert df._DfKernel().axpy_forms == {"plain": 0, "norm": 0}
    before = dict(df.KERNEL.launches)
    forms = dict(df.KERNEL.project_forms), dict(df.KERNEL.axpy_forms)
    v = torch.ones(8)
    df.df_project(v[None], v[None], v, v, 1)
    df.df_normalize((v, v), (v[0], v[1]), (v.clone(), v.clone()))
    df.df_axpy(v, v, v, v, v[None], v[None], 1, norm=True)
    assert df.KERNEL.launches == before
    assert (df.KERNEL.project_forms, df.KERNEL.axpy_forms) == forms
