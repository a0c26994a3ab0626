"""The port's host dense layer against the JAX package's.

The numpy modules of arnoldimethod_torch/dense are copies of the JAX
package's, so on the same seeded Hessenberg matrices their outputs are
bitwise identical.  The port's ctypes binding builds the same C++ core
into build/arnoldimethod_torch and must agree with its numpy layer
(to 1e-12, the tolerance of the JAX package's own native test) and with the
JAX package's binding (bitwise: the same code on the same input)."""

import numpy as np
import pytest

import arnoldimethod_tpu.dense as jdense
import arnoldimethod_tpu.driver as jdrv
import arnoldimethod_torch.dense as tdense
import arnoldimethod_torch.driver as tdrv
from arnoldimethod_tpu.dense import native as jnative
from arnoldimethod_torch.dense import native as tnative
from arnoldimethod_torch.targets import get_order
from utils import normal_hessenberg_matrix
from arnoldimethod_torch import _device


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


DTYPES = [np.float64, np.complex128]
M = 12


def _hessenberg(seed, dtype, m=M):
    """(m+1, m) Hessenberg workspace with a mix of real eigenvalues and
    conjugate pairs (real) or complex eigenvalues, and a nonzero last row."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        vals = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        Hm = normal_hessenberg_matrix(vals, rng, complex_dtype=True)
    else:
        vals = []
        while len(vals) < m:
            if len(vals) % 3 == 0 and len(vals) + 2 <= m:
                a, b = rng.standard_normal(), abs(rng.standard_normal())
                vals += [a + 1j * b, a - 1j * b]
            else:
                vals.append(rng.standard_normal() + 0j)
        Hm = normal_hessenberg_matrix(np.array(vals), rng)
    H = np.zeros((m + 1, m), dtype=dtype)
    H[:m, :] = Hm
    H[m, m - 1] = 0.37
    return H


def _groups(R, seed):
    rng = np.random.default_rng(seed)
    m = R.shape[1]
    groups = np.zeros(m, dtype=int)
    i = 0
    while i < m:
        bs = 1 if jdense.is_start_of_11_block(R, i) else 2
        groups[i : i + bs] = rng.integers(1, 4)
        i += bs
    return groups


def _restart(dense, drv, H0, seed, which):
    """One host restart through a package's numpy layer: Schur form, Ritz
    values and residuals, three-way partition, restore, sort."""
    H = H0.copy()
    m = H.shape[1]
    Q = np.eye(m, dtype=H.dtype)
    dense.local_schur(H[:m, :], 0, m, Q)
    lams = np.zeros(m, dtype=complex)
    dense.copy_eigenvalues(lams, H[:m, :], 0, m)
    rs = np.zeros(m)
    drv._copy_residuals(rs, H, Q, H[m, m - 1], np.zeros(m, dtype=complex), 0, m)
    drv._schur_coupling_floor(rs, H, Q, H[m, m - 1], 0, m)
    drv._partition_three_way(H[:m, :], Q, _groups(H[:m, :], seed))
    k = m - 2 if H[m - 2, m - 3] == 0 else m - 1
    dense.restore_arnoldi(H, 0, k, Q)
    Q2 = np.eye(m, dtype=H.dtype)
    drv._sort_schur(H[:m, :], Q2, m // 2, get_order(which))
    vals = dense.eigenvalues(H[: m // 2, : m // 2])
    return H, Q, lams, rs, Q2, vals


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed,which", [(0, "LM"), (1, "SR"), (2, "LR")])
def test_numpy_layer_is_identical(dtype, seed, which):
    H0 = _hessenberg(seed, dtype)
    jout = _restart(jdense, jdrv, H0, seed, which)
    tout = _restart(tdense, tdrv, H0, seed, which)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(a, b)


def _steps(lib, H0, which, groups_seed=5):
    """The restart steps one by one, each fed the NUMPY layer's output of
    the previous step, so a difference is pinned to one function.  `lib`
    None runs the numpy layer itself."""
    m = H0.shape[1]
    out = {}
    H, Q = H0.copy(), np.eye(m, dtype=H0.dtype)
    (lib or tdense).local_schur(H[:m, :], 0, m, Q)
    out["schur"] = (H, Q)
    H, Q = H0.copy(), np.eye(m, dtype=H0.dtype)
    tdense.local_schur(H[:m, :], 0, m, Q)  # the common input from here on
    lams = np.zeros(m, dtype=complex)
    rs = np.zeros(m)
    if lib is None:
        tdense.copy_eigenvalues(lams, H[:m, :], 0, m)
        tdrv._copy_residuals(rs, H, Q, H[m, m - 1],
                             np.zeros(m, dtype=complex), 0, m)
    else:
        lib.copy_eigenvalues(lams, H[:m, :], 0, m)
        lib.copy_residuals(rs, H[:m, :], Q, H[m, m - 1], 0, m)
    out["ritz"] = (lams, rs)
    groups = _groups(H[:m, :], groups_seed)
    Hp, Qp = H.copy(), Q.copy()
    if lib is None:
        tdrv._partition_three_way(Hp[:m, :], Qp, groups)
    else:
        lib.partition_three_way(Hp[:m, :], Qp, groups)
    out["partition"] = (Hp, Qp)
    Hp, Qp = H.copy(), Q.copy()
    tdrv._partition_three_way(Hp[:m, :], Qp, groups)
    k = m - 2 if Hp[m - 2, m - 3] == 0 else m - 1
    Hr, Qr = Hp.copy(), Qp.copy()
    (lib or tdense).restore_arnoldi(Hr, 0, k, Qr)
    out["restore"] = (Hr, Qr)
    Hs, Qs = H.copy(), np.eye(m, dtype=H.dtype)
    if lib is None:
        tdrv._sort_schur(Hs[:m, :], Qs, m // 2, get_order(which))
    else:
        lib.sort_schur(Hs[:m, :], Qs, m // 2, which)
    out["sort"] = (Hs, Qs)
    return out


def _native_or_skip():
    if not tnative.available():
        pytest.skip(f"native core not built: {tnative.build_error}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed,which", [(3, "LM"), (4, "SR")])
def test_native_binding_matches_numpy_layer(dtype, seed, which):
    _native_or_skip()
    H0 = _hessenberg(seed, dtype)
    nat = _steps(tnative, H0, which)
    ref = _steps(None, H0, which)
    for step in ("schur", "ritz", "restore", "sort"):
        for a, b in zip(nat[step], ref[step]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=step)
    (Hn, Qn), (Hr, Qr) = nat["partition"], ref["partition"]
    np.testing.assert_allclose(Hn, Hr, rtol=0, atol=1e-12)
    # The complex rotations of the two layers may leave Q with different
    # global phases (same R, both valid Schur bases): Qn^H Qr = e^{it} I.
    U = Qn.conj().T @ Qr
    np.testing.assert_allclose(U, U[0, 0] * np.eye(M), rtol=0, atol=1e-12)
    if dtype == np.float64:
        np.testing.assert_allclose(Qn, Qr, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_native_binding_matches_jax_binding(dtype):
    _native_or_skip()
    if not jnative.available():
        pytest.skip("the JAX package's native core is not built")
    H0 = _hessenberg(6, dtype)
    ours, theirs = _steps(tnative, H0, "SR"), _steps(jnative, H0, "SR")
    for step in ours:
        for a, b in zip(ours[step], theirs[step]):
            np.testing.assert_array_equal(a, b, err_msg=step)


def test_native_builds_outside_the_package():
    _native_or_skip()
    lib = tnative._lib._name
    assert "/build/arnoldimethod_torch/" in lib
    assert "/arnoldimethod_torch/dense/" not in lib


def test_native_disabled_by_environment(monkeypatch):
    monkeypatch.setenv("ARNOLDI_TPU_NATIVE", "0")
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build_error", None)
    assert not tnative.available()
    assert "ARNOLDI_TPU_NATIVE" in tnative.build_error
