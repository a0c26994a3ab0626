"""df_axpy's fused norm (ops/df.py) and the expansion that reads it
(ops/df_expansion.py), against the JAX package on the CPU.

With float32 words the plain version of df_axpy(..., norm=True) is bitwise
equal to JAX's op-by-op df_axpy_update_df followed by df_sum(df_mul(x, x))
(df_norm's sum); with float64 words (where JAX's split constant differs,
ROADMAP.md §3) it is held to the port's own plain chain.  The expansion
with the fused norm gives exactly the results and host reads of the
unfused one.  Also: axpy_plan's invariants and the split launch counts
(plain form, fused form, df_normalize) with the C entry stubbed out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnoldimethod_tpu.ops import df32 as jdf32
from arnoldimethod_torch import _device
from arnoldimethod_torch.models import problems as tp
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


N = 1000  # not a power of two: df_sum pads the squares with (0, 0)
M1 = 61


def _pair(rng, dtype, *shape):
    """A normalized double word: the two roundings of a float64 (float32
    words), or hi with a lo 2^-55 its size (float64 words)."""
    x = rng.standard_normal(shape)
    if dtype == np.float32:
        hi = x.astype(np.float32)
        return hi, (x - hi).astype(np.float32)
    return x, rng.standard_normal(shape) * 2.0 ** -55


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (_pair(rng, dtype, N), _pair(rng, dtype, M1),
            _pair(rng, dtype, M1, N))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _same(want, got):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("rows", [0, 1, 31, 61])
@pytest.mark.parametrize("norm", [False, True])
def test_fused_plain_form_matches_jax_op_by_op(rows, norm):
    """float32 words: the update and the sum of squares of its result,
    bitwise JAX's df_axpy_update_df and df_sum(df_mul(x, x))."""
    (wh, wl), (hh, hl), (Vh, Vl) = _inputs(np.float32, rows)
    with jax.disable_jit():
        # JAX's scan takes no empty basis: with no rows w is its own update.
        jw = (jdf32.df_axpy_update_df(
            *(jnp.asarray(a) for a in (wh, wl, hh[:rows], hl[:rows],
                                       Vh[:rows], Vl[:rows])))
              if rows else (jnp.asarray(wh), jnp.asarray(wl)))
        js = jdf32.df_sum(*jdf32.df_mul(*jw, *jw))
    got = df.df_axpy(*_t(wh, wl, hh, hl, Vh, Vl), rows, norm=norm)
    if not norm:
        _same(jw, got)
        return
    (oh, ol), (sh, sl) = got
    assert sh.dim() == sl.dim() == 0
    _same((*jw, *js), (oh, ol, sh, sl))
    # df_norm's sum, the one-row df_project of the result.
    _same(df.df_project(oh[None], ol[None], oh, ol, 1), (sh[None], sl[None]))


@pytest.mark.parametrize("rows", [0, 1, 31, 61])
def test_fused_plain_form_float64_words(rows):
    """float64 words: the port's own plain chain, op by op."""
    w, h, V = (_t(*p) for p in _inputs(np.float64, rows))
    (oh, ol), (sh, sl) = df.df_axpy(*w, *h, *V, rows, norm=True)
    th, tl = w
    for j in range(rows):
        ph, pl = df32.df_mul(h[0][j].expand(N), h[1][j].expand(N), V[0][j],
                             V[1][j])
        th, tl = df32.df_add(th, tl, -ph, -pl)
    assert torch.equal(oh, th) and torch.equal(ol, tl)
    ch, cl = df32.df_sum(*df32.df_mul(th, tl, th, tl))
    assert torch.equal(sh, ch) and torch.equal(sl, cl)
    assert oh.dtype == sh.dtype == torch.float64


def _unfused_masked_project(Vh, Vl, wh, wl, rows, acc=None, norm=False):
    """_masked_project as it was before the fusion: the sum of squares of
    the result by a second df_project (one row)."""
    ch, cl = df.df_project(Vh, Vl, wh, wl, rows, acc)
    out = df.df_axpy(wh, wl, ch, cl, Vh, Vl, rows)
    if not norm:
        return (ch, cl), out
    return (ch, cl), out, tde._sumsq(*out)


def _expand(monkeypatch, fused, case):
    m = 8
    if not fused:
        monkeypatch.setattr(tde, "_masked_project", _unfused_masked_project)
    top = tp.laplacian_1d(N, dtype=torch.float32)
    rng = np.random.default_rng(2)
    if case == "deflating":  # a start in a 4-dimensional invariant subspace
        k = np.arange(1, N + 1)
        v = sum(np.sin(np.pi * f * k / (N + 1)) for f in (1, 2, 5, 9))
    else:
        v = rng.standard_normal(N)
    Vh, Vl = torch.zeros(m + 1, N), torch.zeros(m + 1, N)
    tde.df_set_initial_vector(Vh, Vl, torch.from_numpy(v.astype(np.float32)))
    Hh, Hl = torch.zeros(m + 1, m), torch.zeros(m + 1, m)
    gen = torch.Generator().manual_seed(4)
    syncs = tde.df_expand_range_stepwise(top, Vh, Vl, Hh, Hl, 0, m, gen)
    tde.df_reorthogonalize_row(Vh, Vl, 3)
    monkeypatch.undo()
    return Vh, Vl, Hh, Hl, syncs


@pytest.mark.parametrize("case", ["random", "deflating"])
def test_expansion_with_the_fused_norm_is_unchanged(monkeypatch, case):
    """df_expand_range_stepwise (and a reorthogonalized row) with the
    fused norm: exactly the V, (Hh, Hl) and host reads of the unfused
    expansion; the deflating start takes the second DGKS pass and a random
    row."""
    fused = _expand(monkeypatch, True, case)
    unfused = _expand(monkeypatch, False, case)
    for a, b in zip(fused[:4], unfused[:4]):
        assert torch.equal(a, b)
    assert fused[4] == unfused[4]
    if case == "deflating":
        assert fused[4] > 8  # second passes or a fresh random row ran


def test_dgks_reads_the_fused_sum_with_r2(monkeypatch):
    """_dgks: the same w, h, norm, reference and host reads, with one
    df_project launch fewer a pass (the one-row norm of the result)."""
    (wh, wl), _, (Vh, Vl) = (_t(*p) for p in _inputs(np.float32, 5))
    calls = []
    real = df.df_project

    def spy(*args, **kw):
        calls.append(args[4])
        return real(*args, **kw)

    monkeypatch.setattr(df, "df_project", spy)
    fused = tde._dgks(Vh, Vl, wh, wl, 40)
    n_fused = len(calls)
    monkeypatch.setattr(tde, "_masked_project", _unfused_masked_project)
    unfused = tde._dgks(Vh, Vl, wh, wl, 40)
    for a, b in zip((*fused[0], *fused[1], *fused[2]),
                    (*unfused[0], *unfused[1], *unfused[2])):
        assert torch.equal(a, b)
    assert (tuple(map(float, fused[3])), float(fused[4])) == (
        tuple(map(float, unfused[3])), float(unfused[4]))
    assert fused[5] == unfused[5]
    assert len(calls) - n_fused == n_fused + fused[5]


@pytest.mark.parametrize("n", [1, 5, 100, 1000, 1 << 16, 1021 * 1000,
                               1 << 20, 1 << 24])
def test_axpy_plan(n):
    """N = 2^L T G with (L, U) an instantiated shape; the plain form reads
    runs of a block, the fused norm runs of 128 bytes; where one element a
    thread gives at most 512 blocks, L = 0 and 64 bytes of each word a
    group, else L = 3, U = 2 (fused) or L = 1, U = 2 (plain); the kernel's
    limits on threads and shared memory; the norm's stage a power of two
    within its partials."""
    N = 1 << max(0, n - 1).bit_length()
    for item in (4, 8):
        for rows in (1, 31, 61, 256):
            for norm in (False, True):
                p = df.axpy_plan(n, rows, item, norm)
                assert (p.T << p.L) * p.G == N
                assert (p.L, p.U) in df._AXPY_SHAPES
                assert p.T & (p.T - 1) == 0 and 1 <= p.T <= 256
                assert p.C & (p.C - 1) == 0 and p.C <= p.T
                assert p.stage & (p.stage - 1) == 0 and p.stage <= p.M
                assert p.smem(rows, item, norm) <= 48 * 1024
                few = N // p.T <= 512
                if few:
                    assert (p.L, p.U * item) == (0, 64)
                else:
                    assert (p.L, p.U) == ((3, 2) if norm else (1, 2))
                assert p.C == (min(128 // item, p.T) if norm else p.T)
                if n == 1 << 16:  # config 3: a block on every SM or more
                    assert p.G >= 256


class _Stub:
    """A ctypes library whose entries accept every launch."""

    def __getattr__(self, name):
        return lambda *args: 0


def _stub_kernel(monkeypatch):
    K = df._DfKernel()
    seen = []

    def launch(entry, count, like, *args):
        seen.append((entry, args))
        K.launches[count] += 1

    monkeypatch.setattr(K, "_launch", launch)
    monkeypatch.setattr(K, "_stream_scratch", lambda like, words, slots: (
        torch.zeros(max(words, 1), dtype=like.dtype),
        torch.zeros(max(slots, 1), dtype=torch.int32)))
    return K, seen


def test_launch_counts_split_by_form(monkeypatch):
    """The plain form, the fused norm and df_normalize count apart; the
    step form of df_normalize is one launch too."""
    K, seen = _stub_kernel(monkeypatch)
    v = torch.ones(64)
    V = torch.ones(3, 64)
    K.axpy(v, v, v[:3], v[:3], V, V, 3)
    (out, (sh, sl)) = K.axpy(v, v, v[:3], v[:3], V, V, 2, norm=True)
    K.axpy(v, v, v[:3], v[:3], V, V, 1, norm=True)
    K.normalize(out, (sh, sl), (v, v))
    H, flags = torch.zeros(3, 2), torch.zeros(2)
    K.normalize(out, (sh, sl), (v, v), df.DgksStep(
        (sh, sl), out, (sh, sl), (v[:3], v[:3]), (v[:3], v[:3]), (H, H), 1,
        flags))
    assert K.launches == {"df_project": 0, "df_axpy": 3, "df_normalize": 2,
                          "df_basis_change": 0, "stencil5_df": 0}
    assert K.axpy_forms == {"plain": 1, "norm": 2}
    assert [e for e, _ in seen] == ["df_axpy"] * 3 + ["df_normalize"] * 2
    # The one-sum form passes no second pass and no H; the step form
    # passes H's column j (row j + 1 for the norm) and flags[j].
    assert seen[3][1][4:10] == (None,) * 6
    assert seen[4][1][16:21] == (H.data_ptr() + 4, H.data_ptr() + 4, 2, 2,
                                 flags.data_ptr() + 4)
    assert sh.dim() == sl.dim() == 0
    # The plain form passes no sum and no scratch; the fused form both.
    assert seen[0][1][-1] is None and seen[1][1][-1] is not None


def test_many_rows_chain_launches(monkeypatch):
    """More rows than a launch stages: launches of 256 rows in turn, each
    from the last one's result, the norm fused into the last only."""
    K, seen = _stub_kernel(monkeypatch)
    n, rows = 64, 600
    v = torch.ones(n)
    V = torch.ones(rows, n)
    h = torch.ones(rows)
    K.axpy(v, v, h, h, V, V, rows, norm=True)
    assert [a[7] for _, a in seen] == [256, 256, 88]  # rows a launch
    assert [a[4] for _, a in seen] == [V.data_ptr() + 4 * n * r
                                       for r in (0, 256, 512)]
    assert [a[-1] is None for _, a in seen] == [True, True, False]
    assert K.axpy_forms == {"plain": 2, "norm": 1}


def test_axpy_wrapper_rejects_bad_shapes():
    K = df._DfKernel()
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="rows or shapes"):
        K.axpy(v, v, v, v, v[None], v[None], 2)
    with pytest.raises(ValueError, match="rows or shapes"):
        K.axpy(v, v, v, v, torch.zeros(1, 9), torch.zeros(1, 9), 1)
    with pytest.raises(ValueError, match="share dtype"):
        K.axpy(v, v.double(), v, v, v[None], v[None], 1, norm=True)
