"""Config 3's operator family (bench.py:862-919) against the JAX package:
the Dirichlet convection-diffusion stencil with beta = 2, solved with
extended=True in float32 words from the same v1 in both packages.

At 16 x 16 both take the same number of matvecs from each of three numpy
starts (357, 300, 298).  From 32 x 32 up the count is chaotic at rounding
level (the operator is far from normal): a start perturbed by 1e-7 moves
the port's own count by hundreds, so larger grids can only be compared
statistically (ROADMAP.md, F3).  JAX runs jitted here, as a user runs it.
"""

import numpy as np
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_torch import _device
from arnoldimethod_torch.models import problems as tp

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


NX = 16
# Config 3's Peclet number scaled with the grid: beta = peclet h / 2 = 2.
PECLET = 4.0 * (NX + 1)
KW = dict(nev=10, which="LM", tol=1e-6, mindim=30, maxdim=60,
          restarts=1000, extended=True)


@pytest.mark.parametrize("seed,mvproducts", [(0, 357), (1, 300), (2, 298)])
def test_config3_family_same_count_as_jax(seed, mvproducts):
    v1 = np.random.default_rng(seed).standard_normal(NX * NX)
    jd, jh = jam.partial_schur(
        jp.convection_diffusion_2d(NX, peclet=PECLET, dtype=np.float32,
                                   fmt="stencil"), v1=v1, **KW)
    td, th = tam.partial_schur(
        tp.convection_diffusion_2d(NX, peclet=PECLET, dtype=torch.float32,
                                   fmt="stencil"), v1=v1, **KW)
    assert jh.converged and th.converged and th.nconverged >= 10
    assert (th.mvproducts, th.restarts) == (jh.mvproducts, jh.restarts)
    assert th.mvproducts == mvproducts
    # Pairs of equal real part tie at rounding level: match each eigenvalue
    # to its nearest rather than sorting.
    lj, lt = np.asarray(jd.eigenvalues), np.asarray(td.eigenvalues)
    gap = np.abs(lt[:, None] - lj[None, :]).min(axis=1)
    assert lt.shape == lj.shape and gap.max() <= 1e-9 * np.abs(lj).max()
    assert np.sum(lt.imag > 0) >= 1  # complex pairs, as in config 3


def _counts(nx, seeds, scale=0.0):
    """Matvec counts of both packages at nx^2 from numpy seeds, v1 scaled
    by (1 + scale N(0, 1)) in the port's run when scale > 0."""
    peclet = 4.0 * (nx + 1)
    jop = jp.convection_diffusion_2d(nx, peclet=peclet, dtype=np.float32,
                                     fmt="stencil")
    top = tp.convection_diffusion_2d(nx, peclet=peclet, dtype=torch.float32,
                                     fmt="stencil", device="cpu")
    for seed in seeds:
        v1 = np.random.default_rng(seed).standard_normal(nx * nx)
        if scale:
            noise = np.random.default_rng(100 + seed).standard_normal(nx * nx)
            _, th = tam.partial_schur(top, v1=v1 * (1 + scale * noise), **KW)
            print(f"{nx}^2 seed {seed} perturbed {scale:g}: port {th.mvproducts}")
            continue
        _, jh = jam.partial_schur(jop, v1=v1, **KW)
        _, th = tam.partial_schur(top, v1=v1, **KW)
        print(f"{nx}^2 seed {seed}: JAX {jh.mvproducts}, port {th.mvproducts}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_conv_parity.py 32 [scale]: the
    # counts at a larger grid (minutes on a CPU), where parity is only
    # statistical; with a scale, the port alone from a perturbed seed 0.
    import sys

    import jax

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py sets
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else NX
    scale = float(sys.argv[2]) if len(sys.argv) > 2 else 0.0
    _counts(nx, (0,) if scale else (0, 1, 2), scale)
