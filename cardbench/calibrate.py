"""The readings the correctness limits are set from, at a cell's own size:

    python cardbench/calibrate.py --workload <cell> --seeds 1001-1012 --control 1,2,3

For each seed, one solve of the timed path (the window's own code, closed
after one solve) judged by the reference; then the control, the
reference's answer computed in TF32 put in the program's place, judged by
the same reference, for each control seed.  Prints a JSON line a reading
and last the largest reading of each number over the program's seeds (the
lower reading) and the smallest over the control's (the upper)."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control", type=seeds, default=[])
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    sys.path.insert(0, ROOT)
    from cardbench import harness, reference

    import torch

    if not torch.cuda.is_available():
        sys.exit("cardbench: no CUDA card; no readings")
    cell = harness.load_cell(args.workload)
    ref = reference.recipe_module(cell.cfg["recipe"])
    print(json.dumps({"card": harness.card_info(), "workload": cell.name}),
          flush=True)
    r = harness.Run(cell, "cuda")
    r.setup()
    program, control = [], []
    for seed in args.seeds:
        solves, kept, wall, _ = r.window(seed, 0)
        rows, failed = r.judge(kept)
        program.append(rows[0])
        print(json.dumps({"seed": seed, "wall_s": wall,
                          **solves[0]["history"], **solves[0]["spans"],
                          "numbers": rows[0], "correct": failed == 0}),
              flush=True)
    r.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.control:
        t0 = time.perf_counter()
        nums = ref.check(cell.cfg, ref.control(cell.cfg, seed, "cuda"))
        control.append(nums)
        print(json.dumps({"control_seed": seed, "numbers": nums,
                          "correct": harness.passes(nums, cell.limits),
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    names = list(cell.limits)
    print(json.dumps({
        "lower": {k: max(n[k] for n in program) for k in names},
        "upper": {k: min((n[k] for n in control), default=None)
                  for k in names},
        "limits": cell.limits}), flush=True)


if __name__ == "__main__":
    main()
