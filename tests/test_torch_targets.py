"""The LI and SI targets: the port against the JAX package on a genuinely
complex operator, and the port's refusal of LI/SI for a real dtype.

A real operator's spectrum is symmetric about the real axis, so ordering
by imaginary part is meaningful only in complex arithmetic
(docs/index.md:49-57; the reference's run.jl:53-57).  The JAX package
accepts a real dtype with LI and may return a wrong answer marked
converged; the port raises ValueError and names the complex dtype (a
deliberate divergence).

The parity operator is A + iB with A and B independent normal 60 x 60
matrices and a complex v1, in complex128: both packages make the same
restart decisions, so the matvec counts are equal, the eigenvalues agree
to 1e-10 and Q spans the same subspace.  Real data cast to complex is not
used for exact counts: its conjugate pairs tie at rounding level, and the
two packages may break the tie differently.
"""

import numpy as np
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


KW = dict(nev=4, tol=1e-10)


def _real_case():
    """A real 60 x 60 normal matrix and a start: the first 3,660 normals
    of numpy seed 0."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((60, 60)), rng.standard_normal(60)


def _complex_case():
    """A + iB and v1 + i v1': the real case's draws, then 3,600 and 60
    more normals from the same generator."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((60, 60))
    v1 = rng.standard_normal(60)
    B = rng.standard_normal((60, 60))
    w1 = rng.standard_normal(60)
    return A + 1j * B, v1 + 1j * w1


def _same_schur(jQ, jR, tQ, tR, tol=1e-8):
    """Q spans the same subspace and R agrees after aligning the bases
    (as in tests/test_torch_partial_schur.py)."""
    jQ, tQ = np.asarray(jQ), np.asarray(tQ)
    U = jQ.conj().T @ tQ
    assert np.abs(jQ @ U - tQ).max() <= tol
    assert np.abs(U.conj().T @ np.asarray(jR) @ U - tR).max() <= tol


@pytest.mark.parametrize("which,mvproducts",
                         [("LI", 118), ("SI", 139), ("LM", 141), ("SR", 132)])
def test_complex_operator_matches_jax(which, mvproducts):
    A, v1 = _complex_case()
    jd, jh = jam.partial_schur(A, v1=v1, which=which, method="host", **KW)
    td, th = tam.partial_schur(A, v1=v1, which=which, **KW)
    assert jh.converged and th.converged
    assert td.Q.dtype == torch.complex128
    assert th.mvproducts == jh.mvproducts == mvproducts
    assert th.nconverged == jh.nconverged
    assert np.abs(td.eigenvalues - jd.eigenvalues).max() <= 1e-10
    _same_schur(jd.Q, jd.R, td.Q.numpy(), td.R)
    Q = td.Q.numpy()
    assert np.linalg.norm(A @ Q - Q @ td.R) <= 1e-8
    # The wanted end of the spectrum: no eigenvalue of A lies beyond the
    # converged ones in the target's order.
    key = {"LI": lambda z: -z.imag, "SI": lambda z: z.imag,
           "LM": lambda z: -abs(z), "SR": lambda z: z.real}[which]
    lam = np.linalg.eigvals(A)
    worst = max(key(z) for z in td.eigenvalues)
    assert sum(key(z) < worst - 1e-10 for z in lam) <= len(td.eigenvalues) - 1


def test_real_dtype_with_li_jax_converges_to_a_wrong_answer():
    """The JAX package's result that the port refuses: converged, with a
    Schur residual of order one."""
    A, v1 = _real_case()
    jd, jh = jam.partial_schur(A, v1=v1, which="LI", method="host",
                               restarts=1000, **KW)
    Q = np.asarray(jd.Q)
    assert jh.converged
    assert np.linalg.norm(A @ Q - Q @ np.asarray(jd.R)) > 1.0
    with pytest.raises(ValueError, match="complex128"):
        tam.partial_schur(A, v1=v1, which="LI", restarts=1000, **KW)


@pytest.mark.parametrize("dtype,name", [(torch.float32, "complex64"),
                                        (torch.float64, "complex128")])
@pytest.mark.parametrize("which", ["LI", "SI", "li", tam.LI(), tam.SI()],
                         ids=["LI", "SI", "li", "LI()", "SI()"])
def test_real_dtype_with_li_or_si_raises(which, dtype, name):
    A, v1 = _real_case()
    op = tam.DenseOperator(torch.from_numpy(A).to(dtype))
    with pytest.raises(ValueError, match=f"needs a complex.*{name}"):
        tam.partial_schur(op, v1=v1, which=which, **KW)


def test_real_data_as_complex_with_li_is_accepted():
    """The same real matrix with a complex dtype solves for LI."""
    A, v1 = _real_case()
    td, th = tam.partial_schur(A.astype(np.complex128), v1=v1, which="LI",
                               **KW)
    assert th.converged
    Q = td.Q.numpy()
    assert np.linalg.norm(A @ Q - Q @ td.R) <= 1e-8
    lam = np.linalg.eigvals(A)
    assert np.abs(np.sort(td.eigenvalues.imag)[::-1]
                  - np.sort(lam.imag)[::-1][:len(td.eigenvalues)]).max() <= 1e-8
