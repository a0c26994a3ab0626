"""The port's BSR matvec (arnoldimethod_torch/ops/bsr.py) and BsrOperator
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
and its einsum path, on the same seeded operands.

On the CPU the port's wrapper takes the plain PyTorch version; the CUDA
kernel it launches on a card is compared with that plain version by
chip_smoke.py.  Tolerances: float64 1e-10 absolute (as tests/test_bsr.py);
float32 per entry 2 * KB * B * eps * (|A| |x|), the rounding of two sums of
KB * B products taken in different orders."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu as jam
from arnoldimethod_tpu.models.operators import (
    BsrOperator as JBsr,
    CsrOperator as JCsr,
    dense_to_bsr as jdense_to_bsr,
)
from arnoldimethod_tpu.ops import bsr_pallas
import arnoldimethod_torch as tam
from arnoldimethod_torch.models.operators import (
    BsrOperator,
    CsrOperator,
    dense_to_bsr,
)
from arnoldimethod_torch.ops import bsr
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


DTYPES = [np.float32, np.float64]


def _block_matrix(rng, n, B, fill=0.3):
    """Dense matrix with a random block pattern (as tests/test_bsr.py)."""
    nb = n // B
    A = np.zeros((n, n))
    for i in range(nb):
        for j in range(nb):
            if i == j or rng.random() < fill:
                A[i * B:(i + 1) * B, j * B:(j + 1) * B] = rng.standard_normal((B, B))
    return A


def _padding_operands(nbr, KB, B, dtype):
    """Operands whose KB is no multiple of 8 and whose nbr is no multiple
    of 8, with duplicate block columns when KB > nbr (as
    tests/test_bsr.py::test_bsr_padding_paths)."""
    rng = np.random.default_rng(3)
    kb_eff = min(KB, nbr)
    block_cols = np.stack(
        [np.sort(rng.choice(nbr, size=kb_eff, replace=False)) for _ in range(nbr)]
    )
    if kb_eff < KB:
        block_cols = np.concatenate(
            [block_cols, rng.integers(0, nbr, (nbr, KB - kb_eff))], axis=1
        )
    block_data = rng.standard_normal((nbr, KB, B, B)).astype(dtype)
    x = rng.standard_normal(nbr * B).astype(dtype)
    return block_cols.astype(np.int32), block_data, x


def _clustered_csr(n, seed=9):
    """A band plus one dense corner block, as CSR arrays (as
    tests/test_bsr.py::test_csr_to_bsr_roundtrip)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for i in range(n):
        for j in range(max(0, i - 3), min(n, i + 4)):
            A[i, j] = rng.standard_normal()
    k = n // 4
    A[:k, -k:] = rng.standard_normal((k, k))
    indptr, idx, vals = [0], [], []
    for i in range(n):
        nz = np.nonzero(A[i])[0]
        idx.append(nz.astype(np.int32))
        vals.append(A[i, nz])
        indptr.append(indptr[-1] + len(nz))
    return A, np.asarray(indptr), np.concatenate(idx), np.concatenate(vals)


def _assert_close(y_port, y_ref, cols, dataT, x):
    """float64: 1e-10 absolute; float32: 2 KB B eps (|A||x|) per entry."""
    y_port, y_ref = np.asarray(y_port), np.asarray(y_ref)
    assert y_port.shape == y_ref.shape
    err = np.abs(y_port.astype(np.float64) - y_ref)
    if dataT.dtype == torch.float64:
        assert err.max() <= 1e-10
        return
    KB, B = dataT.shape[1], dataT.shape[-1]
    ax = bsr.bsr_plain(cols, dataT.double().abs(), x.double().abs()).numpy()
    bound = 2 * KB * B * np.finfo(np.float32).eps * ax[: y_ref.shape[0]]
    assert np.all(err <= bound)


def _torch(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("B", [8, 32])
def test_dense_blocks_match_jax(B, dtype):
    rng = np.random.default_rng(0)
    n = 8 * B
    A = _block_matrix(rng, n, B).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    jop, top = jdense_to_bsr(A, B), dense_to_bsr(A, B)
    np.testing.assert_array_equal(top.block_cols.numpy(), np.asarray(jop.block_cols))
    np.testing.assert_array_equal(top.block_dataT.numpy(), np.asarray(jop.block_dataT))
    xt = torch.from_numpy(x)
    y_kernel = np.asarray(bsr_pallas.bsr_matvec(
        jop.block_cols, jop.block_dataT, jnp.asarray(x), interpret=True))
    y_port = bsr.bsr_matvec(top.block_cols, top.block_dataT, xt)
    assert y_port.dtype == xt.dtype
    _assert_close(y_port, y_kernel, top.block_cols, top.block_dataT, xt)
    y_op = top.matvec(xt)
    _assert_close(y_op, np.asarray(jop.matvec(jnp.asarray(x))),
                  top.block_cols, top.block_dataT, xt)
    _assert_close(y_op, A.astype(np.float64) @ x, top.block_cols,
                  top.block_dataT, xt)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("nbr,KB,B", [(3, 11, 8), (5, 3, 16), (3, 9, 8)])
def test_padding_paths_match_jax(nbr, KB, B, dtype):
    block_cols, block_data, x = _padding_operands(nbr, KB, B, dtype)
    n = nbr * B
    jop = JBsr(block_cols, block_data, (n, n), use_pallas=False)
    top = BsrOperator(block_cols, block_data, (n, n))
    xt = torch.from_numpy(x)
    y_kernel = np.asarray(bsr_pallas.bsr_matvec(
        jop.block_cols, jop.block_dataT, jnp.asarray(x), interpret=True))[:n]
    _assert_close(top.matvec(xt), y_kernel, top.block_cols, top.block_dataT, xt)
    _assert_close(top.matvec(xt), np.asarray(jop.matvec(jnp.asarray(x))),
                  top.block_cols, top.block_dataT, xt)
    # The plain version alone takes the unpacked operands too.
    dataT = _torch(block_data.transpose(0, 1, 3, 2))
    _assert_close(bsr.bsr_plain(_torch(block_cols), dataT, xt), y_kernel,
                  _torch(block_cols), dataT, xt)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("nbr,KB,B", [(3, 11, 8), (5, 3, 16), (3, 9, 8)])
def test_from_packed_jax_operands_match_jax(nbr, KB, B, dtype):
    """JAX's packed operands and logical extents give the port's operator
    the same extents and matvec; the logical extents change no entry."""
    block_cols, block_data, x = _padding_operands(nbr, KB, B, dtype)
    n = nbr * B
    jop = JBsr(block_cols, block_data, (n, n), use_pallas=False)
    top = BsrOperator.from_packed(np.asarray(jop.block_cols),
                                  _torch(jop.block_dataT), jop.logical_blocks,
                                  jop.shape)
    assert top.logical_blocks == jop.logical_blocks == (nbr, KB)
    assert top.logical_blocks != tuple(top.block_dataT.shape[:2])
    xt = torch.from_numpy(x)
    _assert_close(top.matvec(xt), np.asarray(jop.matvec(jnp.asarray(x))),
                  top.block_cols, top.block_dataT, xt)
    y = bsr.bsr_matvec(top.block_cols, top.block_dataT, xt, top.logical_blocks)
    assert torch.equal(y, bsr.bsr_matvec(top.block_cols, top.block_dataT, xt))


# The launch plan: every (nbr, KB) of this grid, both SM counts, at each
# (B, itemsize) of the parametrisation.
_PLAN_NBR = (1, 8, 40, 64, 512, 4096)
_PLAN_KB = (1, 6, 16, 64)
_PLAN_SMS = (132, 114)


def _check_plan(nbr, KB, B, itemsize, sms, aligned):
    p = bsr.bsr_plan(nbr, KB, B, itemsize, sms, aligned)
    assert 1 <= p.S <= min(8, KB)
    assert p.grid == nbr * p.S and p.grid % p.S == 0
    # Chunks: contiguous, in rank order, non-empty, the kernel's formula.
    assert p.chunks == tuple((s * KB // p.S, (s + 1) * KB // p.S)
                             for s in range(p.S))
    assert p.chunks[0][0] == 0 and p.chunks[-1][1] == KB
    assert all(k0 < k1 == n0 for (k0, k1), (n0, _) in zip(p.chunks, p.chunks[1:]))
    # Every (block-row, logical slot) is summed by exactly one CTA.
    cover = np.zeros((nbr, KB), dtype=np.int64)
    for cta in range(p.grid):
        k0, k1 = p.chunks[cta % p.S]
        cover[cta // p.S, k0:k1] += 1
    assert (cover == 1).all()
    # About two CTAs per SM wherever KB allows.
    assert nbr * p.S >= 2 * sms or p.S == min(8, KB)
    if nbr >= 2 * sms:
        assert p.S == 1
    # Resources and the alignment of the bulk path.
    assert p.smem_bytes <= bsr.MAX_SMEM_BYTES == 232_448
    assert 1 <= p.threads <= 1024 and (p.threads * p.vec) % B == 0
    assert p.stage_elems % (p.threads * p.vec) == 0
    assert p.stage_bytes == p.stage_elems * itemsize < 2 ** 20
    assert p.xrows % (p.stage_elems // B) == 0
    if p.path == "bulk":
        assert aligned and (B * B * itemsize) % 16 == 0
        assert p.vec * itemsize == 16 and p.stage_bytes % 16 == 0
        assert p.stages in (1, 2) and p.stage_bytes <= 64 * 1024
    else:
        assert p.path == "direct" and p.vec == 1 and p.stages == 0
        assert not aligned or (B * B * itemsize) % 16 != 0
    return p


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 2, 3, 8, 32, 128, 512, 1024])
def test_plan_properties(B, itemsize):
    for nbr in _PLAN_NBR:
        for KB in _PLAN_KB:
            for sms in _PLAN_SMS:
                p = _check_plan(nbr, KB, B, itemsize, sms, True)
                _check_plan(nbr, KB, B, itemsize, sms, False)
                assert (p.path == "bulk") == (B % 2 == 0)


def test_plan_fills_the_card_with_few_block_rows():
    """The shapes the redesign is for: few block-rows split their slots;
    many block-rows keep one CTA each."""
    assert bsr.bsr_plan(8, 6, 128, 4, 132).S == 6
    assert bsr.bsr_plan(64, 8, 128, 4, 132).S == 8
    assert bsr.bsr_plan(16, 16, 512, 4, 132).grid == 128
    assert bsr.bsr_plan(512, 8, 128, 4, 132).S == 1
    assert bsr.bsr_plan(512, 8, 128, 4, 132).path == "bulk"
    with pytest.raises(ValueError):
        bsr.bsr_plan(8, 8, 1025, 4, 132)


def _chunked_matvec(cols, dataT, x, plan, logical):
    """The kernel's order of sums, by chunk: each rank's slots of a
    block-row summed, then the chunks added in rank order; pad rows 0."""
    nbr, KB = logical
    B = dataT.shape[-1]
    gathered = x.reshape(-1, B)[cols[:nbr, :KB].long()]
    y = torch.zeros(dataT.shape[0], B, dtype=x.dtype)
    for k0, k1 in plan.chunks:
        y[:nbr] += torch.einsum("rkji,rkj->ri", dataT[:nbr, k0:k1],
                                gathered[:, k0:k1])
    return y.reshape(-1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("nbr,KB,B", [(3, 11, 8), (5, 3, 16), (2, 16, 4), (9, 6, 8)])
def test_order_of_sums_matches_jax(nbr, KB, B, dtype):
    """Summing by the plan's chunks in rank order agrees with JAX's Pallas
    kernel (interpret mode) and with bsr_plain."""
    block_cols, block_data, x = _padding_operands(nbr, KB, B, dtype)
    cols, dataT = (_torch(a) for a in bsr.pack_bsr(block_cols, block_data))
    xt = _torch(np.pad(x, (0, cols.shape[0] * B - x.size)))
    plan = bsr.bsr_plan(nbr, KB, B, np.dtype(dtype).itemsize, 132)
    assert plan.S == min(8, KB) > 1
    y = _chunked_matvec(cols, dataT, xt, plan, (nbr, KB))
    y_kernel = np.asarray(bsr_pallas.bsr_matvec(
        jnp.asarray(cols.numpy()), jnp.asarray(dataT.numpy()),
        jnp.asarray(xt.numpy()), interpret=True))
    _assert_close(y, y_kernel, cols, dataT, xt)
    _assert_close(y, bsr.bsr_plain(cols, dataT, xt).numpy(), cols, dataT, xt)
    assert not y[nbr * B:].any()


@pytest.mark.parametrize("n,B", [(96, 16), (100, 16), (75, 8)])
def test_csr_to_bsr_matches_jax(n, B):
    """n not a block multiple pads x inside the matvec; the spectrum is
    untouched."""
    A, indptr, idx, vals = _clustered_csr(n)
    jop = JCsr(indptr, idx, vals, (n, n)).to_bsr(block_size=B, use_pallas=False)
    top = CsrOperator(indptr, idx, vals, (n, n)).to_bsr(block_size=B)
    assert top.shape == (n, n) and top.logical_blocks == jop.logical_blocks
    assert top.fill_ratio == jop.fill_ratio >= 1.0
    np.testing.assert_array_equal(top.block_cols.numpy(), np.asarray(jop.block_cols))
    np.testing.assert_array_equal(top.block_dataT.numpy(), np.asarray(jop.block_dataT))
    x = np.random.default_rng(9).standard_normal(n)
    xt = torch.from_numpy(x)
    y = top.matvec(xt)
    assert y.shape == (n,)
    nbc = -(-n // B)
    y_kernel = np.asarray(bsr_pallas.bsr_matvec(
        jop.block_cols, jop.block_dataT, jnp.pad(jnp.asarray(x), (0, nbc * B - n)),
        interpret=True))[:n]
    for ref in (y_kernel, np.asarray(jop.matvec(jnp.asarray(x))), A @ x):
        assert np.abs(y.numpy() - ref).max() <= 1e-10


@pytest.mark.parametrize("nbr,KB,B", [(8, 8, 4), (3, 11, 8), (5, 3, 16), (9, 1, 2)])
def test_pack_bsr_matches_jax(nbr, KB, B):
    block_cols, block_data, _ = _padding_operands(nbr, KB, B, np.float32)
    jc, jd = bsr_pallas.pack_bsr(block_cols, block_data)
    tc, td = bsr.pack_bsr(block_cols, block_data)
    assert tc.dtype == jc.dtype == np.int32 and td.dtype == jd.dtype
    assert tc.tobytes() == jc.tobytes() and td.tobytes() == jd.tobytes()
    assert tc.shape[0] % 8 == 0 and tc.shape[1] % min(8, KB) == 0


def test_packed_operands_required():
    rng = np.random.default_rng(0)
    bc = rng.integers(0, 8, (8, 12)).astype(np.int32)
    bd = rng.standard_normal((8, 12, 8, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="packed"):
        bsr_pallas.bsr_matvec(jnp.asarray(bc), jnp.asarray(bd),
                              jnp.ones(64, jnp.float32), interpret=True)
    with pytest.raises(ValueError, match="packed"):
        bsr.bsr_matvec(_torch(bc), _torch(bd), torch.ones(64))


def _operands(nbr=2, KB=2, B=4, dtype=torch.float32):
    return (torch.zeros(nbr, KB, dtype=torch.int32),
            torch.zeros(nbr, KB, B, B, dtype=dtype),
            torch.zeros(nbr * B, dtype=dtype))


def _bad(case):
    cols, data, x = _operands()
    if case == "dtype":
        return cols, data.half(), x.half()
    if case == "complex":
        return cols, data.to(torch.complex64), x.to(torch.complex64)
    if case == "mixed_dtypes":
        return cols, data.double(), x
    if case == "cols_dtype":
        return cols.long(), data, x
    if case == "strided_x":
        return cols, data, torch.zeros(16)[::2]
    if case == "nbc":
        return cols, data, torch.zeros(10)
    if case == "cols_shape":
        return torch.zeros(2, 3, dtype=torch.int32), data, x
    if case == "block_size":
        return (torch.zeros(1, 1, dtype=torch.int32),
                torch.zeros(1, 1, 1025, 1025), torch.zeros(1025))
    if case == "non_square":
        return cols, torch.zeros(2, 2, 4, 3), x
    if case == "logical_rows":
        return cols, data, x, (3, 2)
    if case == "logical_slots":
        return cols, data, x, (2, 3)
    if case == "logical_negative":
        return cols, data, x, (-1, 2)
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case,err,match",
    [("dtype", TypeError, "float32"), ("complex", TypeError, "imaginary words"),
     ("mixed_dtypes", TypeError, "block data"), ("cols_dtype", TypeError, "int32"),
     ("strided_x", ValueError, "contiguous"), ("nbc", ValueError, "multiple"),
     ("cols_shape", ValueError, "block_cols"), ("block_size", ValueError, "square"),
     ("non_square", ValueError, "square"),
     ("logical_rows", ValueError, "logical_blocks"),
     ("logical_slots", ValueError, "logical_blocks"),
     ("logical_negative", ValueError, "logical_blocks")],
)
def test_kernel_wrapper_rejects_bad_input(case, err, match):
    """The checks run before the kernel is built, so they hold here."""
    with pytest.raises(err, match=match):
        bsr._BsrKernel()(*_bad(case))


def test_kernel_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        bsr._BsrKernel().load()


def test_non_cpu_tensor_never_takes_the_plain_version():
    cols, data, _ = _operands(nbr=8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        bsr.bsr_matvec(cols, data, torch.empty(8 * 4, device="meta"))


def test_launch_count_starts_at_zero_and_plain_does_not_count():
    assert bsr._BsrKernel().launches == 0
    before = bsr.KERNEL.launches
    cols, data, x = _operands(nbr=8)
    bsr.bsr_matvec(cols, data, x)
    bsr.bsr_plain(cols, data, x)
    assert bsr.KERNEL.launches == before


def test_operator_takes_the_dispatch_unless_told_not_to(monkeypatch):
    calls = []
    real = bsr.bsr_matvec

    def spy(cols, dataT, x, logical_blocks=None):
        calls.append((x.dtype, logical_blocks))
        return real(cols, dataT, x, logical_blocks)

    monkeypatch.setattr(bsr, "bsr_matvec", spy)
    block_cols, block_data, x = _padding_operands(3, 9, 8, np.float64)
    n = 24
    xt = torch.from_numpy(x)
    ys = [BsrOperator(block_cols, block_data, (n, n), use_pallas=u).matvec(xt)
          for u in (None, True, False)]
    assert calls == [(torch.float64, (3, 9))] * 2
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])


def test_block_columns_checked_at_construction():
    block_cols, block_data, _ = _padding_operands(3, 3, 4, np.float64)
    block_cols[1, 2] = 3  # nbc = 3 block columns: 0, 1, 2
    with pytest.raises(ValueError, match="block columns"):
        BsrOperator(block_cols, block_data, (12, 12))
    with pytest.raises(ValueError):
        dense_to_bsr(np.eye(100), 16)


def test_operator_properties_match_jax():
    rng = np.random.default_rng(5)
    A = _block_matrix(rng, 48, 8)
    jop, top = jdense_to_bsr(A, 8), dense_to_bsr(A, 8)
    assert top.nnz == jop.nnz and top.block_size == jop.block_size == 8
    assert top.logical_blocks == jop.logical_blocks
    assert top.shape == jop.shape and top.dtype == torch.float64
    np.testing.assert_array_equal(top.block_data.numpy(), np.asarray(jop.block_data))


def test_complex_blocks_take_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(6)
    A = _block_matrix(rng, 32, 8) + 1j * _block_matrix(rng, 32, 8)
    x = rng.standard_normal(32) + 1j * rng.standard_normal(32)
    for u in (None, False):
        y = dense_to_bsr(A, 8, use_pallas=u).matvec(torch.from_numpy(x))
        assert y.dtype == torch.complex128
        assert np.abs(y.numpy() - A @ x).max() <= 1e-12


def _v1(n, seed=11):
    return np.random.default_rng(seed).standard_normal(n)


def _same_solve(jd, jh, td, th):
    assert th.converged and jh.converged
    assert th.mvproducts == jh.mvproducts
    assert th.nconverged == jh.nconverged
    assert np.abs(td.eigenvalues - jd.eigenvalues).max() <= 1e-10


def test_bsr_solve_matches_jax():
    rng = np.random.default_rng(1)
    A = _block_matrix(rng, 128, 16, fill=0.2)
    v1 = _v1(128)
    kw = dict(nev=4, which="LM", tol=1e-9)
    jd, jh = jam.partial_schur(jdense_to_bsr(A, 16, use_pallas=False), v1=v1,
                               method="host", **kw)
    td, th = tam.partial_schur(dense_to_bsr(A, 16), v1=v1, **kw)
    _same_solve(jd, jh, td, th)


def test_csr_to_bsr_solve_matches_jax():
    """An irregular CSR matrix re-blocked to BSR (n = 120, blocks of 32:
    x is padded) solves as the JAX package's does."""
    rng = np.random.default_rng(11)
    n = 120
    A = np.diag(np.linspace(1.0, 5.0, n))
    for _ in range(300):
        i, j = rng.integers(0, n, 2)
        A[i, j] += 0.1 * rng.standard_normal()
    indptr = np.r_[0, np.cumsum((A != 0).sum(axis=1))]
    rows, cols = np.nonzero(A)
    vals = A[rows, cols]
    v1 = _v1(n, seed=12)
    kw = dict(nev=4, which="LM", tol=1e-9)
    jd, jh = jam.partial_schur(
        JCsr(indptr, cols, vals, (n, n)).to_bsr(32, use_pallas=False), v1=v1,
        method="host", **kw)
    td, th = tam.partial_schur(
        CsrOperator(indptr, cols, vals, (n, n)).to_bsr(32), v1=v1, **kw)
    _same_solve(jd, jh, td, th)
