"""BENCHMARK.json and the files it names, by the benchmark's rules."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "cardbench/run.py"]
    assert manifest["paths"] == ["cardbench"]
    assert 1 <= manifest["run_seconds"] <= 51


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    names += [w["traffic"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [m["name"] for m in metrics]
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in manifest[group]]
        assert len(seen) == len(set(seen))
    seen = [m["name"] for m in metrics]
    assert len(seen) == len(set(seen))


def test_one_line_texts(manifest):
    texts = [w["why"] for w in manifest["workloads"]]
    texts += [c["source"] for c in manifest["configs"]]
    texts += [m["layer"] for m in manifest["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_configs_are_files_under_paths(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["file"].startswith("cardbench/configs/")
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in manifest["workloads"])


def test_cells_find_their_files(manifest):
    from cardbench import harness

    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4)
        cell = harness.load_cell(w["name"])
        assert (ROOT / "cardbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert cell.cfg["name"] == w["config"]


def test_every_cell_has_a_cut_for_the_cpu_tests(manifest):
    """The tests run every cell of BENCHMARK.json at the size the `small`
    key of its limits/<cell>.json gives."""
    for w in manifest["workloads"]:
        with open(ROOT / "cardbench" / "limits" / f"{w['name']}.json") as f:
            cut = json.load(f).get("small")
        assert cut and set(cut) <= {"operator", "recipe"}, w["name"]


def test_limits_lie_between_their_readings(manifest):
    """Each cell's limits (limits/<cell>.json): one for each number its
    reference compares, above the program's largest reading and below the
    control's smallest, which is at least three times it; exact numbers
    have the limit 0."""
    from cardbench import harness, reference

    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"])
        with open(ROOT / "cardbench" / "limits" / f"{w['name']}.json") as f:
            data = json.load(f)
        ref = reference.recipe_module(cell.cfg["recipe"])
        assert set(data["limits"]) == set(ref.NUMBERS)
        for k, limit in data["limits"].items():
            lower, upper = data["lower"][k], data["upper"][k]
            if limit == 0:
                assert lower == 0
                continue
            assert upper >= 3 * lower
            assert lower < limit < upper
            # More room above the program's reading than below the
            # control's.
            assert limit / lower > upper / limit


def test_every_metric_has_a_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (ROOT / "cardbench" / "metrics" / f"{m['name']}.py").is_file()


def test_end_to_end_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_what_their_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in reporting
        layers.setdefault(m["layer"], set()).add(m["name"])
    # Every cell reports setup_s, another end-to-end metric and a
    # per-layer metric.
    for cell in cells:
        assert sum(cell in m.get("workloads", cells)
                   for m in manifest["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in manifest["per_layer"])


def test_roofline_names(manifest):
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"


def test_check_fits_the_time_budget(manifest):
    # A full check with 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    # 2 x 90 s a cell to compile and 1200 s spare, within 43,200 s.
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_size_of_file():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
