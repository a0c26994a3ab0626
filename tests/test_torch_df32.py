"""The port's double-word arithmetic (arnoldimethod_torch/ops/df32.py)
against the JAX package's ops/df32.py, on the same seeded numpy inputs.

float32 words: every op is bitwise equal to JAX's, at a non-power-of-two n
too.  JAX's functions run op by op (`jax.disable_jit()`): inside a compiled
scan XLA:CPU contracts the products the JAX package does not pin
(`pe + (xh * yl + xl * yh)` in df_mul, `pe + xl * c` in df_scale) into
FMAs, which moves their low words by an ulp; op by op every step is one
IEEE-rounded operation, which is the arithmetic both packages document.

float64 words: the port splits at 2^27 + 1, so its two_prod is exact
(checked with exact rationals); JAX splits at 2^12 + 1 for every word type
and its float64-word two_prod is not exact (a test shows it).  The other
ops then agree with JAX to 16 eps64 of the operands' magnitude.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnoldimethod_tpu.ops import df32 as jdf
from arnoldimethod_torch import _device
from arnoldimethod_torch.ops import df32 as tdf

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


N = 1000  # not a power of two: df_sum pads
M = 5
EPS64 = np.finfo(np.float64).eps


def _inputs(dtype, seed=0):
    """Seeded double-word operands: vectors of N, an (M, N) basis, M
    coefficients, a scalar; lo words at the hi words' rounding level."""
    rng = np.random.default_rng(seed)
    lo = 2.0 ** (-26 if dtype == np.float32 else -55)

    def pair(*shape):
        h = rng.standard_normal(shape).astype(dtype)
        return h, (rng.standard_normal(shape) * lo).astype(dtype)

    xh, xl = pair(N)
    yh, yl = pair(N)
    Vh, Vl = pair(M, N)
    hh, hl = pair(M)
    c = dtype(0.7431)
    return dict(xh=xh, xl=xl, yh=yh, yl=yl, Vh=Vh, Vl=Vl, hh=hh, hl=hl, c=c,
                X2h=pair(3, N)[0], X2l=pair(3, N)[1])


# name -> (args as keys of _inputs, kwargs)
OPS = {
    "two_sum": (("xh", "yh"), {}),
    "two_prod": (("xh", "yh"), {}),
    "df_add": (("xh", "xl", "yh", "yl"), {}),
    "df_sub": (("xh", "xl", "yh", "yl"), {}),
    "df_mul": (("xh", "xl", "yh", "yl"), {}),
    "df_scale": (("xh", "xl", "c"), {}),
    "df_scale_by_vector": (("xh", "xl", "yh"), {}),
    "df_sum": (("xh", "xl"), {}),
    "df_sum_rows": (("X2h", "X2l"), {"axis": -1}),
    "df_sum_cols": (("X2h", "X2l"), {"axis": 0}),
    "df_dot": (("xh", "yh"), {}),
    "df_project_coeffs": (("Vh", "xh", "xl"), {}),
    "df_project_coeffs_df": (("Vh", "Vl", "xh", "xl"), {}),
    "df_axpy_update": (("xh", "xl", "hh", "hl", "Vh"), {}),
    "df_axpy_update_df": (("xh", "xl", "hh", "hl", "Vh", "Vl"), {}),
    "df_inv": (("xh", "xl"), {}),
    "df_norm": (("xh", "xl"), {}),
}


def _fn(module, name):
    base = {"df_scale_by_vector": "df_scale", "df_sum_rows": "df_sum",
            "df_sum_cols": "df_sum"}.get(name, name)
    return getattr(module, base)


def _run_both(name, dtype):
    keys, kw = OPS[name]
    data = _inputs(dtype)
    args = [data[k] for k in keys]
    with jax.disable_jit():
        j = _fn(jdf, name)(*(jnp.asarray(a) for a in args), **kw)
    t = _fn(tdf, name)(*(torch.from_numpy(np.array(a)) for a in args), **kw)
    return [np.asarray(a) for a in j], [b.numpy() for b in t], data


@pytest.mark.parametrize("name", sorted(OPS))
def test_f32_words_bitwise_equal_to_jax(name):
    j, t, _ = _run_both(name, np.float32)
    for a, b in zip(j, t):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _magnitude(name, d):
    """A float64 bound on the magnitude of the op's exact result terms."""
    ax, ay = np.abs(d["xh"]).astype(np.float64), np.abs(d["yh"]).astype(np.float64)
    aV = np.abs(d["Vh"]).astype(np.float64)
    return {
        "df_add": ax + ay, "df_sub": ax + ay, "df_mul": ax * ay,
        "df_scale": ax * abs(float(d["c"])), "df_scale_by_vector": ax * ay,
        "df_sum": np.sum(ax), "df_dot": np.sum(ax * ay),
        "df_project_coeffs_df": aV @ ax,
        "df_axpy_update_df": ax + np.abs(d["hh"]) @ aV,
        "df_inv": 1.0 / ax, "df_norm": np.sqrt(np.sum(ax * ax)),
    }[name]


@pytest.mark.parametrize(
    "name", ["df_add", "df_sub", "df_mul", "df_scale", "df_scale_by_vector",
             "df_sum", "df_dot", "df_project_coeffs_df", "df_axpy_update_df",
             "df_inv", "df_norm"])
def test_f64_words_agree_with_jax_within_bound(name):
    """The combined value hi + lo of each result, port against JAX, within
    16 eps64 of the magnitude of the exact terms: JAX's inexact float64
    split costs it about one float64 rounding a product."""
    j, t, d = _run_both(name, np.float64)
    diff = np.abs((t[0] - j[0]) + (t[1] - j[1]))
    assert np.all(diff <= 16 * EPS64 * _magnitude(name, d))


def _pairs(dtype, n=2000):
    rng = np.random.default_rng(3)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal(n).astype(dtype))


def _inexact(a, b, p, e):
    """How many (a, b, p, e) have p + e != a * b in exact rationals."""
    F = Fraction
    return sum(F(float(pp)) + F(float(ee)) != F(float(x)) * F(float(y))
               for x, y, pp, ee in zip(a, b, p, e))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_two_prod_is_exact(dtype):
    """p + e == a * b exactly, in exact rationals, for both word types."""
    a, b = _pairs(dtype)
    p, e = tdf.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    assert _inexact(a, b, p.numpy(), e.numpy()) == 0


def test_jax_two_prod_is_not_exact_with_float64_words():
    """The JAX package's split constant 2^12 + 1 leaves the float64-word
    product's error word inexact for nearly every random pair (the port
    differs here on purpose)."""
    a, b = _pairs(np.float64)
    p, e = jdf.two_prod(jnp.asarray(a), jnp.asarray(b))
    assert _inexact(a, b, np.asarray(p), np.asarray(e)) > len(a) // 2


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_split_halves_sum_to_the_word(dtype):
    a, _ = _pairs(dtype)
    hi, lo = tdf.split(torch.from_numpy(a))
    assert np.array_equal(hi.numpy() + lo.numpy(), a)
    # The same split on host scalars (the stencil kernel's coefficients).
    for x, h, lw in zip(a[:50], hi.numpy(), lo.numpy()):
        hs, ls = tdf.split(x)
        assert type(hs) is type(ls) is dtype
        assert _bits(hs) == _bits(h) and _bits(ls) == _bits(lw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pre_split_operands_give_the_same_bits(dtype):
    """two_prod and df_scale from operands split beforehand (as the kernels
    split each operand once for all its products) equal the unsplit ops bit
    for bit, on tensors and on a host scalar coefficient."""
    a, b = (torch.from_numpy(v) for v in _pairs(dtype))
    lo = b * dtype(2.0 ** (-26 if dtype == np.float32 else -55))
    want = tdf.two_prod(a, b)
    for a_split, b_split in ((tdf.split(a), None), (None, tdf.split(b)),
                             (tdf.split(a), tdf.split(b))):
        got = tdf.two_prod(a, b, a_split, b_split)
        assert all(np.array_equal(_bits(g.numpy()), _bits(w.numpy()))
                   for g, w in zip(got, want))
    for c in (dtype(-1.2), dtype(4.3), dtype(0.0)):
        want = tdf.df_scale(b, lo, c)
        got = tdf.df_scale(b, lo, c, tdf.split(b), tdf.split(c))
        assert all(np.array_equal(_bits(g.numpy()), _bits(w.numpy()))
                   for g, w in zip(got, want))


def test_split_constant():
    assert tdf.split_constant(torch.float32) == 2.0 ** 12 + 1
    assert tdf.split_constant(torch.float64) == 2.0 ** 27 + 1
    with pytest.raises(TypeError):
        tdf.split_constant(torch.float16)


def test_two_sum_keeps_its_error_word():
    """A rewrite of (a + b) - a into b would zero the error word."""
    s, e = tdf.two_sum(torch.tensor(3.0), torch.tensor(1e-9))
    assert s.item() == 3.0 and e.item() != 0.0
    assert abs(s.item() + e.item() - (3.0 + 1e-9)) < 1e-18


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_norm_of_zero_is_zero(dtype):
    z = torch.zeros(7, dtype=dtype)
    nh, nl = tdf.df_norm(z, z)
    assert nh.item() == 0.0 and nl.item() == 0.0


def test_df_sqrt_finishes_df_norm():
    """df_norm is df_sqrt of the double-word sum of squares."""
    d = _inputs(np.float32)
    xh, xl = torch.from_numpy(d["xh"]), torch.from_numpy(d["xl"])
    sh, sl = tdf.df_sum(*tdf.df_mul(xh, xl, xh, xl))
    for a, b in zip(tdf.df_norm(xh, xl), tdf.df_sqrt(sh, sl)):
        assert torch.equal(a, b)


def test_stencil_f32_words_same_count_as_jax():
    """A whole extended solve over the stencil's double-word path: an
    anisotropic 2-D stencil (simple spectrum; tests/test_extended.py's
    config at 12 x 12), nev=4, :SR, tol=1e-10, from one v1: JAX's matvec
    count, eigenvalues of the float32 coefficients to 1e-9."""
    from arnoldimethod_tpu import partial_schur as jps
    from arnoldimethod_tpu.models.operators import Stencil5Operator as JS
    from arnoldimethod_torch import partial_schur as tps
    from arnoldimethod_torch.models.operators import Stencil5Operator as TS

    coeffs, grid = (4.6, -1.0, -1.0, -1.3, -1.3), (12, 12)
    v1 = np.random.default_rng(12).standard_normal(144)
    kw = dict(nev=4, which="SR", tol=1e-10, extended=True, v1=v1)
    _, jh = jps(JS(coeffs, grid, dtype=jnp.float32), **kw)
    td, th = tps(TS(coeffs, grid, dtype=torch.float32), **kw)
    assert th.converged and th.mvproducts == jh.mvproducts
    c, w, no = (float(np.float32(v)) for v in coeffs[:2] + coeffs[3:4])
    cos = np.cos(np.pi * np.arange(1, 13) / 13)
    exact = np.sort((c + 2 * w * cos[:, None] + 2 * no * cos[None, :]).ravel())
    assert np.abs(np.sort(td.eigenvalues.real) - exact[:4]).max() < 1e-9


def test_plain_calls_on_the_cpu_are_not_counted():
    before = tdf.PLAIN_ON_CARD
    d = _inputs(np.float32)
    tdf.df_norm(torch.from_numpy(d["xh"]), torch.from_numpy(d["xl"]))
    assert tdf.PLAIN_ON_CARD == before
