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
with the plain ops: the class walk in bit-reversed order plus the halving
of the partials reproduces df32.df_sum's tree exactly.
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
    DiaOperator,
    Stencil5Operator,
)
from arnoldimethod_torch.ops import df, df32
from arnoldimethod_torch.ops import df_expansion as tde

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


def _bitrev(r, bits):
    return int(format(r, f"0{bits}b")[::-1], 2) if bits else 0


def _kernel_order_sum(xh, xl, M):
    """df_project's two passes emulated with the plain ops: thread t folds
    the class {t + s M} with s in bit-reversed order through a binary-counter
    stack, then the M partials go through the halving tree."""
    n = xh.shape[-1]
    N = 1 << max(0, n - 1).bit_length()
    L = (N // M).bit_length() - 1
    pad = (0, N - n)
    xh = torch.nn.functional.pad(xh, pad)
    xl = torch.nn.functional.pad(xl, pad)
    t = torch.arange(M)
    stack = {}
    for r in range(N // M):
        idx = t + _bitrev(r, L) * M
        ch, cl = xh[idx], xl[idx]
        lev = 0
        while (r >> lev) & 1:
            ch, cl = df32.df_add(*stack[lev], ch, cl)
            lev += 1
        stack[lev] = (ch, cl)
    ph, pl = stack[L]
    while ph.shape[0] > 1:
        half = ph.shape[0] // 2
        ph, pl = df32.df_add(ph[:half], pl[:half], ph[half:], pl[half:])
    return ph[0], pl[0]


@pytest.mark.parametrize("n", [1, 5, 64, 1000, 1024, 3000])
def test_kernel_order_of_sums_is_df_sums_tree(n):
    rng = np.random.default_rng(n)
    xh, xl = _t(*_pair(rng, n))
    want = df32.df_sum(xh, xl)
    M_plan = df.project_plan(n)[0]
    for M in sorted({m for m in (1, 4, 64, M_plan) if m <= M_plan}):
        got = _kernel_order_sum(xh, xl, M)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), M


@pytest.mark.parametrize("n", [1, 2, 100, 1000, 4096, 1 << 20, 1021 * 1000])
def test_project_plan(n):
    M, T = df.project_plan(n)
    pow2 = 1 << max(0, n - 1).bit_length()
    assert M & (M - 1) == 0 and 1 <= M <= min(pow2, 2048)
    assert 1 <= T <= 128 and M % T == 0


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


def test_normalize_matches_jax(basis):
    _, _, wh, wl, _, _ = basis
    with jax.disable_jit():
        (jsh, jsl), (jnh, jnl) = jde._df_normalize(*_j(wh, wl))
    twh, twl = _t(wh, wl)
    nh, nl = tde._norm(twh, twl)  # host numpy scalars
    assert type(nh) is type(nl) is np.float32
    _same((jnh, jnl, jsh, jsl),
          (*_t(nh, nl), *tde._normalize(twh, twl, nh, nl)))
    # df_mul_by's plain version with host scalars is df_mul.
    out = (torch.empty(N), torch.empty(N))
    df.df_mul_by(twh, twl, nh, nl, out=out)
    _same(df32.df_mul(twh, twl, *_t(nh, nl)), out)


def test_host_scalar_ops_equal_the_tensor_ops():
    """df_sqrt and df_inv on numpy scalars (the host side of the solve)
    give the bits of the same ops on 0-dim tensors, in both word types."""
    rng = np.random.default_rng(10)
    for dtype in (np.float32, np.float64):
        for x in rng.standard_normal(50) ** 2:
            h = dtype(x)
            lo = dtype((x - float(h)) if dtype == np.float32 else x * 2.0 ** -60)
            for fn in (df32.df_sqrt, df32.df_inv):
                a = fn(h, lo)
                b = fn(*_t(h, lo))
                assert all(type(v) is dtype for v in a)
                _same([np.asarray(v) for v in a], b)


def test_basis_change_matches_jax(basis):
    Vh, Vl, _, _, Qh, Ql = basis
    with jax.disable_jit():
        jout = jde.df_apply_basis_change(*_j(Vh, Vl, Qh, Ql))
    tVh, tVl, tQh, tQl = _t(Vh, Vl, Qh, Ql)
    _same(jout, df.df_basis_change(tVh, tVl, tQh, tQl))
    tde.df_apply_basis_change(tVh, tVl, tQh, tQl)  # in place
    _same(jout, (tVh, tVl))


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
    syncs = tde.df_expand_range(top, Vh, Vl, Hh, Hl, 0, m, torch.Generator())
    assert m <= syncs <= 2 * m
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


def test_truncate_and_expand_matches_jax():
    """A restart's device step: basis change by an orthogonal (m+1) matrix
    split into two words, then expansion from k = 3."""
    m, k = 6, 3
    jop, top = jp.laplacian_1d(N, dtype=F32), tp.laplacian_1d(N, dtype=torch.float32)
    V0 = _start(N, m)
    Vh, Vl = _port_start(V0)
    Hh, Hl = torch.zeros(m + 1, m), torch.zeros(m + 1, m)
    tde.df_expand_range(top, Vh, Vl, Hh, Hl, 0, m, torch.Generator())
    Q = np.linalg.qr(np.random.default_rng(2).standard_normal((m + 1, m + 1)))[0]
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
    with pytest.raises(ValueError, match="contiguous"):
        K.mul_by(torch.zeros(16)[::2], torch.zeros(8), 1.0, 0.0)
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
        ("df_project", "df_axpy", "df_basis_change", "stencil5_df"), 0)
    before = dict(df.KERNEL.launches)
    v = torch.ones(8)
    df.df_project(v[None], v[None], v, v, 1)
    df.df_mul_by(v, v, 1.0, 0.0)
    assert df.KERNEL.launches == before
