"""One run of one cell: set-up, the measured window, the reference's
judgement and the result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json at
the checkout's root, its configuration in the file BENCHMARK.json names,
its traffic mix in traffic/<traffic>.json, the limits of its correctness
numbers in limits/<cell>.json, the program's operator in
systems/<operator.kind>.py, the way a solve is driven in
recipes/<recipe.kind>.py, the reference in reference/<operator.kind>.py
and reference/<recipe.kind>.py, and each metric's reader in
metrics/<metric>.py."""

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from cardbench import reference, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "arnoldimethod_tpu")


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix and
    metrics (end-to-end and per-layer entries that apply to it)."""

    def __init__(self, name, cfg, mix, chips, end_to_end, per_layer, limits):
        self.name, self.cfg, self.mix, self.chips = name, cfg, mix, chips
        self.end_to_end, self.per_layer = end_to_end, per_layer
        self.limits = limits


def load_manifest(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"cardbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(Path(root) / conf["file"]) as f:
        cfg = json.load(f)

    def applies(m):
        return name in m.get("workloads", [name])

    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    return Cell(name, cfg, traffic.load(w["traffic"]), w["chips"],
                [m for m in manifest["end_to_end"] if applies(m)],
                [m for m in manifest["per_layer"] if applies(m)], limits)


def reader(metric):
    """The module metrics/<metric>.py (found by file, so that any metric
    name is a file name)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Device:
    """The card, or the CPU for the tests: synchronize and memory readings."""

    def __init__(self, torch, kind):
        self.torch, self.kind = torch, kind
        self.cuda = kind == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def allocated(self):
        return self.torch.cuda.memory_allocated() if self.cuda else 0

    def peak(self):
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def describe(self, count):
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": count}
        return {"platform": "gpu",
                "kind": self.torch.cuda.get_device_name(0), "count": count}


def recipe_module(cfg):
    return importlib.import_module(f"cardbench.recipes.{cfg['recipe']['kind']}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden(err):
    """Exit with code 3, no result, if JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        print(f"cardbench: modules loaded that a run may not load: {found}",
              file=err)
        raise SystemExit(3)


def card_info():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"nvidia_smi": f"not read: {exc}"}
    return {"nvidia_smi": proc.stdout.strip().splitlines()}


class Run:
    """The phases of a run, in order: setup(), window(), then after
    peak() the traced slice (optional), free() and judge()."""

    def __init__(self, cell, device="cuda"):
        import torch

        self.torch = torch
        self.cell = cell
        self.dev = Device(torch, device)
        self.device = device
        self.recipe = recipe_module(cell.cfg)
        self.state = None

    def start(self, seed, i):
        op = self.state["op"]
        return traffic.start_vector(self.torch, op.shape[0], op.dtype,
                                    self.device, seed, i)

    def setup(self):
        """The program's operator and a warm-up of the cell's own shapes
        (its first run builds the program's kernels)."""
        self.state = self.recipe.prepare(self.cell.cfg, self.cell.mix,
                                         self.device)
        # The warm-up's start is none of the window's.
        self.recipe.warm_up(self.state, self.start(-1, 0))
        self.dev.sync()

    def window(self, seed, seconds):
        """The closed loop: returns (solves, kept, window_s, peak_bytes).
        Each solve is timed from the call to a synchronize after its
        result; the program's peak memory is read a solve at a time, the
        answers the benchmark keeps for the reference subtracted."""
        solves, kept, held, peak = [], [], 0, 0
        first = last = None
        for i in traffic.closed_loop(seconds):
            x0 = self.start(seed, i)
            self.dev.reset_peak()
            t0 = time.perf_counter()
            out, spans = self.recipe.solve(self.state, x0, traffic.start_seed(seed, i))
            self.dev.sync()
            t1 = time.perf_counter()
            peak = max(peak, self.dev.peak() - held)
            before = self.dev.allocated()
            k, hist = self.recipe.keep(out)
            held += self.dev.allocated() - before
            del out, x0
            first = t0 if first is None else first
            last = t1
            kept.append(k)
            solves.append({"i": i, "wall_s": t1 - t0, "history": hist,
                           "spans": spans})
        return solves, kept, last - first, peak

    def traced_slice(self, seed):
        from cardbench import profiling

        parts = self.recipe.slice_parts(self.state, self.start(seed, 0))
        return profiling.run(self.torch, parts, self.dev.sync, self.dev.cuda)

    def free(self):
        self.state = None
        gc.collect()
        if self.dev.cuda:
            self.torch.cuda.empty_cache()

    def judge(self, kept):
        """Each kept answer's numbers (reference/<recipe>.check), freeing
        each answer once judged.  Returns (numbers a solve, failed)."""
        cfg = self.cell.cfg
        ref = reference.recipe_module(cfg["recipe"])
        limits = self.cell.limits
        saved = self.torch.backends.cuda.matmul.allow_tf32
        self.torch.backends.cuda.matmul.allow_tf32 = False
        try:
            rows, failed = [], 0
            while kept:
                nums = ref.check(cfg, kept.pop(0))
                rows.append(nums)
                failed += not passes(nums, limits)
        finally:
            self.torch.backends.cuda.matmul.allow_tf32 = saved
        return rows, failed


def passes(nums, limits):
    """Every number finite and within its limit."""
    return all(nums[k] == nums[k] and nums[k] <= limits[k] for k in limits)


def worst(rows, limits):
    """The largest reading of each number over the solves, beside its
    limit."""
    return {k: {"value": max((r[k] for r in rows), default=float("nan")),
                "limit": limits[k]} for k in limits}


def run(cell, seed, seconds, trace, device="cuda", t_start=None,
        out=sys.stdout, err=sys.stderr):
    """One run; prints the result line last on `out` and returns it."""
    t_start = time.perf_counter() if t_start is None else t_start
    r = Run(cell, device)
    r.setup()
    setup_s = time.perf_counter() - t_start
    solves, kept, window_s, peak = r.window(seed, seconds)
    refuse_forbidden(err)
    record = {"cell": cell.name, "config": cell.cfg, "mix": cell.mix,
              "dtype": cell.cfg["operator"]["dtype"], "setup_s": setup_s,
              "window_s": window_s, "solves": solves, "peak_bytes": peak,
              "slice": r.traced_slice(seed) if trace else None}
    r.free()
    rows, failed = r.judge(kept)
    checks = worst(rows, cell.limits)
    correct = bool(solves) and failed == 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(r.dev.describe(cell.chips), memory_peak_bytes=peak)
    line = {"correct": correct, "attempted": len(solves), "failed": failed,
            "metrics": metrics, "device": dev}
    if trace:
        main = record["slice"]["steps"]
        dev["busy_s"], dev["window_s"] = main["busy_s"], main["wall_s"]
        from cardbench.profiling import device_ops

        line["breakdown"] = {"device_ops": device_ops(main),
                             "idle_gaps": [[k[:160], v]
                                           for k, v in main["gaps"][:10]]}
    line["checks"] = checks
    # Again, for what the slice, the reference and the readers loaded.
    refuse_forbidden(err)

    print(json.dumps({"card": card_info() if r.dev.cuda else "cpu",
                      "seed": seed, "seconds": seconds, "trace": trace}),
          file=out)
    print(json.dumps({"solves": [
        {"i": s["i"], "wall_s": s["wall_s"], **s["history"], **s["spans"],
         "numbers": n} for s, n in zip(solves, rows)]}), file=out)
    if trace:
        print(json.dumps({"slice": {
            name: {k: v for k, v in part.items() if k not in ("ops",)}
            for name, part in record["slice"].items()}}), file=out)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    print(json.dumps(line), file=out, flush=True)
    err.flush()
    return line
