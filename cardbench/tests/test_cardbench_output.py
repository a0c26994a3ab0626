"""The result line's keys and the refusals of run.py."""

import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, small_cell
from cardbench import harness


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(trace):
    out, err = io.StringIO(), io.StringIO()
    cell = small_cell("lap2d1m.host")
    harness.run(cell, 7, 0.2, trace, device="cpu", out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    checks = line["checks"]
    assert set(checks) == set(cell.limits)
    tail = err.getvalue().strip().splitlines()[-len(checks):]
    assert [t.split()[1] for t in tail] == list(checks)


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "lap2d1m.host",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    proc = _run_py(ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "arnoldimethod_torch" in proc.stderr
