"""Build-at-first-use helper for the port's native libraries.

Every native piece of the port is a plain shared library with a C
interface, loaded through ctypes: the C++ dense restart core
(`dense/arnoldi_dense.cpp`, built with g++) and the CUDA kernels
(`csrc/stencil5.cu`, `csrc/bsr.cu`, `csrc/df.cu`, `csrc/dense_restart.cu`,
built with nvcc; each is built at its first use, or all at once by
`build_all`).  The sources ship inside the package.  In a source checkout
the libraries are compiled into `build/arnoldimethod_torch/` beside the
package (listed in `.gitignore`); an installed copy (no `pyproject.toml`
beside the package, or a parent that is not writable) builds into
`$XDG_CACHE_HOME/arnoldimethod_torch/build` (`~/.cache` when the variable
is unset), never into site-packages.  A library's name carries a hash of
the sources and the command, so an edit to either rebuilds.  The compiler
writes to a temporary name that is renamed into place, so concurrent
processes (test workers) never load a half-written library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
REPO_DIR = PACKAGE_DIR.parent


def _build_dir():
    """The checkout's build directory, or the user's cache for an
    installed copy."""
    if (REPO_DIR / "pyproject.toml").is_file() and os.access(REPO_DIR, os.W_OK):
        return REPO_DIR / "build" / "arnoldimethod_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "arnoldimethod_torch" / "build"


BUILD_DIR = _build_dir()

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_command(what):
    """The nvcc command line (without output and sources) for a CUDA
    kernel of the port; raises RuntimeError when no CUDA toolkit is found."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            f"the {what} kernel needs the CUDA toolkit (nvcc): none found "
            "(set CUDA_HOME)"
        )
    return [f"{CUDA_HOME}/bin/nvcc", *NVCC_FLAGS]


def build_all():
    """Build (or load) every native library of the port at once, one thread
    each: the CUDA kernels `csrc/stencil5.cu`, `csrc/bsr.cu`, `csrc/df.cu`
    and `csrc/dense_restart.cu` with nvcc, and the C++ dense core with g++.  Returns the
    seconds each took, by name.  A failed CUDA build raises; the dense core
    reports its failure through `dense.native.build_error` (the numpy layer
    then runs)."""
    from concurrent.futures import ThreadPoolExecutor

    from .dense import device, native
    from .ops import bsr, df, stencil

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    jobs = {"stencil5": stencil.KERNEL.load, "bsr": bsr.KERNEL.load,
            "df": df.KERNEL.load, "dense_restart": device.KERNEL.load,
            "dense": native.available}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def build_shared(name, sources, command, timeout=600):
    """Compile `sources` with `command` (a list ending before the output
    and source arguments) into BUILD_DIR/lib<name>-<hash>.so unless it
    exists; return (path, compiler stderr or "" when nothing was built).
    Raises RuntimeError with the compiler's stderr if the build fails."""
    sources = [Path(s) for s in sources]
    digest = hashlib.sha256(" ".join(command).encode())
    for s in sources:
        digest.update(s.read_bytes())
    path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [*command, "-o", tmp, *map(str, sources)],
            capture_output=True,
            text=True,
            timeout=timeout,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {path.name} failed ({command[0]} exit "
                f"{proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stderr
