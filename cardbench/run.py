"""Run one cell of the benchmark once:

    python cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds arnoldimethod_torch.  Prints the
result as the last line of standard output (see README.md)."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Run as a script, this folder leads sys.path: put the checkout's root
    # there instead, so that no file here stands in for a module elsewhere.
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, ROOT)
    from cardbench import harness

    cell = harness.load_cell(args.workload)
    harness.recipe_module(cell.cfg)  # the program: no result without it
    import torch

    if not torch.cuda.is_available():
        sys.exit("cardbench: no CUDA card (torch.cuda.is_available() is "
                 "false); no result")
    if torch.cuda.device_count() < cell.chips:
        sys.exit(f"cardbench: the cell asks for {cell.chips} cards, "
                 f"{torch.cuda.device_count()} found; no result")
    harness.run(cell, args.seed, args.seconds, args.trace, "cuda",
                t_start=T_START)


if __name__ == "__main__":
    main()
