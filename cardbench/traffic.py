"""The one traffic generator: reads a mix's parameters from
`traffic/<name>.json` and hands out the solves of a run.

A mix is a closed loop: one caller starts a solve when the last one has
returned, as a user sweeping parameters or restarting jobs does.  Solves
start while fewer than the run's seconds have passed since the first one
started, and the last is let finish.  Solve i of a run with seed s starts
from a standard normal vector drawn on the device from a generator seeded
with numpy's SeedSequence([s, i]); the same seed gives the same starts."""

import json
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
KNOWN = {"loop", "callers", "start", "method", "why"}


def load(name):
    """The mix's parameters from traffic/<name>.json, checked."""
    path = HERE / "traffic" / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    unknown = set(mix) - KNOWN
    if unknown:
        raise ValueError(f"{path}: unknown keys {sorted(unknown)}")
    if mix.get("loop") != "closed" or mix.get("callers") != 1:
        raise ValueError(f"{path}: only a closed loop of one caller is known")
    if mix.get("start") != "standard_normal":
        raise ValueError(f"{path}: only standard_normal starts are known")
    return mix


def start_seed(seed, i):
    """The 63-bit seed of solve i's start in a run with `seed` (any whole
    number, negative ones too)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), int(i)])
    return int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def start_vector(torch, n, dtype, device, seed, i):
    """Solve i's start: n standard normal values drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(start_seed(seed, i))
    return torch.randn(n, generator=gen, dtype=dtype, device=device)


def closed_loop(seconds):
    """Yield 0, 1, 2, ...: the index of each solve to start.  The first
    always starts; a later one starts while fewer than `seconds` have
    passed since the first started.  Call after the previous solve has
    returned."""
    i, t0 = 0, None
    while True:
        now = time.perf_counter()
        if t0 is None:
            t0 = now
        elif now - t0 >= seconds:
            return
        yield i
        i += 1
