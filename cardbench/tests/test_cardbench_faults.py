"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card is skipped (device="cpu", each cell cut to
a CPU size) and the rest of a run is driven as it is on the card.

The faults an eigensolver cell can have: a step that returns its state
unchanged (the operator hands back its input), an answer altered where it
is produced (the operator's output off by 1 %), and half of the batch left
out (the solve returns half of its Schur vectors and eigenvalues and
claims the whole).  One card a cell: there is no exchange between cards
to leave out."""

import io
import json

import pytest

import arnoldimethod_torch as am
from arnoldimethod_torch.models.operators import Stencil5Operator

from conftest import cells, small_cell
from cardbench import harness

CELLS = cells()


def _run(name):
    out, err = io.StringIO(), io.StringIO()
    harness.run(small_cell(name), 2**31 + 11, 0.3, 0, device="cpu",
                out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_state_returned_unchanged(name, monkeypatch):
    monkeypatch.setattr(Stencil5Operator, "matvec", lambda self, x: x.clone())
    line = _run(name)
    assert not line["correct"] and line["failed"] == line["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced(name, monkeypatch):
    plain = Stencil5Operator.matvec
    monkeypatch.setattr(Stencil5Operator, "matvec",
                        lambda self, x: plain(self, x) * 1.01)
    line = _run(name)
    assert not line["correct"] and line["failed"] == line["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_batch_left_out(name, monkeypatch):
    solve = am.partial_schur

    def half(*args, **kw):
        d, h = solve(*args, **kw)
        k = d.Q_rows.shape[0] // 2
        return am.PartialSchur(None, d.R[:k, :k], d.eigenvalues[:k],
                               Q_rows=d.Q_rows[:k]), h

    monkeypatch.setattr(am, "partial_schur", half)
    line = _run(name)
    assert not line["correct"] and line["failed"] == line["attempted"]
