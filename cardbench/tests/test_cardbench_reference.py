"""The plain reference against a dense matrix and an arnoldimethod_torch
solve, and its control, on the CPU.  The test may import the program;
the reference may not."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import ROOT, cells, small_cell
from cardbench import harness, reference
from cardbench.reference import round_tf32
from cardbench.reference import stencil5 as ref_stencil

SPEC = {"kind": "stencil5", "coeffs": [0.52, -0.13, -0.13, -0.13, -0.13],
        "grid": [6, 7], "boundary": "dirichlet", "dtype": "float32"}


def dense(spec):
    c, w, e, no, so = spec["coeffs"]
    ny, nx = spec["grid"]
    A = np.zeros((ny * nx, ny * nx))
    for y in range(ny):
        for x in range(nx):
            i = y * nx + x
            A[i, i] = c
            if x > 0:
                A[i, i - 1] = w
            if x < nx - 1:
                A[i, i + 1] = e
            if y > 0:
                A[i, i - nx] = no
            if y < ny - 1:
                A[i, i + nx] = so
    return A


def test_matvec_and_spectrum_against_dense():
    A = dense(SPEC)
    X = torch.randn(3, 42, dtype=torch.float64)
    got = ref_stencil.matvec_rows(X, SPEC).numpy()
    assert np.allclose(got, X.numpy() @ A.T, atol=1e-14)
    assert np.allclose(ref_stencil.smallest(SPEC, 9),
                       np.linalg.eigvalsh(A)[:9], atol=1e-13)
    assert ref_stencil.norm_bound(SPEC) == pytest.approx(1.04)


def test_matvec_agrees_with_the_programs_stencil():
    from arnoldimethod_torch import Stencil5Operator

    op = Stencil5Operator(tuple(SPEC["coeffs"]), tuple(SPEC["grid"]),
                          dtype=torch.float64, device="cpu")
    x = torch.randn(42, dtype=torch.float64)
    ref = ref_stencil.matvec_rows(x[None], SPEC)[0]
    assert torch.allclose(op.matvec(x), ref, atol=1e-14)


def test_closed_form_refuses_an_unsymmetric_stencil():
    spec = dict(SPEC, coeffs=[4.0, -1.2, -0.8, -1.0, -1.0])
    with pytest.raises(ValueError):
        ref_stencil.smallest(spec, 3)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -3.0000002])
    got = round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]


LAP = dict(SPEC, grid=[64, 64])


def _low(nev):
    return ref_stencil.smallest(LAP, 2 * nev)


def test_eigen_numbers_take_one_copy_of_a_double_only():
    """The exact low end passes; so does one copy of each double with the
    next values in place of the second copies.  Leaving out a wanted
    value, or returning a simple one twice, does not."""
    from cardbench.reference.partial_schur import eigen_numbers

    nev, scale = 8, 1.04
    low = _low(nev)
    exact = eigen_numbers(low[:nev], low, nev, scale)
    assert exact["eig_err"] < 1e-15 and exact["multiplicity_errors"] == 0
    distinct = [v for i, v in enumerate(low) if i == 0 or v - low[i - 1] > 1e-12]
    copies = eigen_numbers(np.array(distinct[:nev]), low, nev, scale)
    assert copies["eig_err"] < 1e-15 and copies["multiplicity_errors"] == 0
    assert copies["beyond_nev"] == nev - len(
        [v for v in distinct if v <= low[nev - 1] + 1e-12])
    gap = (low[1] - low[0]) / scale
    no_first = eigen_numbers(np.append(low[1:nev], low[nev]), low, nev,
                             scale)
    assert no_first["eig_err"] >= 0.99 * gap
    assert no_first["multiplicity_errors"] >= 1
    twice = eigen_numbers(np.append(low[0], low[:nev - 1]), low, nev, scale)
    assert twice["multiplicity_errors"] >= 1
    # A simple eigenvalue's place taken by the next value past the nev-th.
    simple = [i for i in range(1, nev - 1)
              if low[i] - low[i - 1] > 1e-12 and low[i + 1] - low[i] > 1e-12]
    skipped = np.append(np.delete(low[:nev], simple[0]), low[nev])
    assert eigen_numbers(skipped, low, nev, scale)["multiplicity_errors"] >= 1


def test_a_left_out_value_counts_however_near_its_neighbour():
    """At lap2d1m's size the 20 smallest hold (1,4), (4,1) and (3,3),
    1.17e-6 apart in eig_err's units: leaving out (3,3) for the next value
    reads an eig_err of that gap, and two multiplicity errors: the value
    left out, and the one past the nev-th in the place of no copy."""
    from cardbench.reference.partial_schur import eigen_numbers

    spec = dict(SPEC, grid=[1024, 1024])
    nev, scale = 20, 1.04
    low = ref_stencil.smallest(spec, 2 * nev)
    i33 = 10  # (3, 3): j^2 + k^2 = 18, after 2, 5, 5, 8, 10, 10, 13, 13, 17, 17
    assert low[i33] - low[i33 - 1] > 1e-12 < low[i33 + 1] - low[i33]
    vals = np.append(np.delete(low[:nev], i33), low[nev])
    nums = eigen_numbers(vals, low, nev, scale)
    assert nums["multiplicity_errors"] == 2
    assert 1.1e-6 < nums["eig_err"] < 1.2e-6


@pytest.mark.parametrize("name", cells())
def test_reference_passes_a_program_solve(name):
    cell = small_cell(name)
    r = harness.Run(cell, "cpu")
    r.setup()
    solves, kept, _, _ = r.window(12345, 0)
    assert len(solves) == 1
    r.free()
    rows, failed = r.judge(kept)
    assert failed == 0, rows
    nums = rows[0]
    assert nums["nconverged_short"] == 0
    assert nums["eig_err"] < 1e-6


@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails(name, seed):
    """The reference's answer computed in TF32, in the program's place, is
    refused by the committed limits."""
    cell = small_cell(name)
    ref = reference.recipe_module(cell.cfg["recipe"])
    nums = ref.check(cell.cfg, ref.control(cell.cfg, seed, "cpu"))
    assert not harness.passes(nums, cell.limits), nums


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_control_fails_at_cell_size(card, name):
    cell = harness.load_cell(name)
    ref = reference.recipe_module(cell.cfg["recipe"])
    nums = ref.check(cell.cfg, ref.control(cell.cfg, 1, card))
    assert not harness.passes(nums, cell.limits), nums


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "cardbench" / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("numpy", "torch", "math", "importlib", "cardbench")
            assert not name.startswith("cardbench.") or name.startswith(
                "cardbench.reference"), (path, name)
