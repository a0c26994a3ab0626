"""Tests of the benchmark, on the CPU.  A test that needs a CUDA card
carries the `card` marker and takes the `card` fixture, which skips it
where there is none (decided when the test runs, never at import)."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def cells():
    """The cells BENCHMARK.json declares: every test that runs a cell runs
    each of them, so a cell added as files and entries is tested too."""
    from cardbench import harness

    return [w["name"] for w in harness.load_manifest()["workloads"]]


def merged(base, cut):
    """`base` with every number of `cut` put in, nested groups merged."""
    out = copy.deepcopy(base)
    for k, v in cut.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) else v
    return out


def small_cell(name):
    """The cell cut to a size a CPU test holds, by the `small` key of its
    limits/<cell>.json: the grid, nev and dimensions shrink; the recipe,
    the mix, the reference and the limits stay the cell's."""
    from cardbench import harness

    cell = harness.load_cell(name)
    path = ROOT / "cardbench" / "limits" / f"{name}.json"
    cut = json.loads(path.read_text()).get("small")
    if not cut:
        pytest.fail(f"{path} has no `small` cut for the CPU tests")
    cell.cfg = merged(cell.cfg, cut)
    return cell
