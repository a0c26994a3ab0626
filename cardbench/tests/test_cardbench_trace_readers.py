"""The readers of the program's own spans (History.timings' parts), from a
traced run of the cut lap2d1m.host cell on the CPU, and from a record of
a program that keeps no such parts."""

import io
import json

import pytest

from conftest import small_cell
from cardbench import harness

# The host cell's readers of the parts; the filtered cell has the first
# two as "<name>.filtered".
PARTS = ("sync_wait_s_per_solve", "expansion_self_ms_per_step",
         "dense_schur_s_per_solve", "dense_reorder_s_per_solve")
READERS = PARTS + ("sync_wait_s_per_solve.filtered",
                   "expansion_self_ms_per_step.filtered")


@pytest.fixture(scope="module")
def metrics():
    out, err = io.StringIO(), io.StringIO()
    harness.run(small_cell("lap2d1m.host"), 11, 0.2, 1, device="cpu",
                out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return {k: v["value"] for k, v in line["metrics"].items()}


def test_the_parts_report_in_the_host_cell(metrics):
    assert set(PARTS) <= set(metrics)


def test_the_waits_lie_inside_the_expansion(metrics):
    assert 0 < metrics["sync_wait_s_per_solve"] <= metrics[
        "expansion_s_per_solve"]
    assert metrics["expansion_self_ms_per_step"] > 0


def test_the_dense_parts_lie_inside_the_dense_restart(metrics):
    schur = metrics["dense_schur_s_per_solve"]
    reorder = metrics["dense_reorder_s_per_solve"]
    assert schur > 0 and reorder > 0
    assert schur + reorder <= metrics["dense_s_per_solve"]


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_parts_reads_none(name):
    """An earlier program's History.timings has "device" and "dense"
    alone: each reader leaves its metric out, and raises nothing."""
    record = {"solves": [{"history": {
        "mvproducts": 100, "host_syncs": 200, "restarts": 3,
        "timings": {"device": 1.0, "dense": 0.1}}}]}
    assert harness.reader(name).read(record) is None


def test_self_time_per_step():
    record = {"solves": [
        {"history": {"mvproducts": 100,
                     "timings": {"device": 1.0, "sync_wait": 0.4}}},
        {"history": {"mvproducts": 300,
                     "timings": {"device": 2.0, "sync_wait": 1.4}}}]}
    read = harness.reader("expansion_self_ms_per_step.filtered").read
    assert read(record) == pytest.approx(1e3 * 1.2 / 400)
