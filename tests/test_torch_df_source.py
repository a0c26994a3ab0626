"""The CUDA source of the double-word basis change and stencil
(arnoldimethod_torch/csrc/df.cu) run on the CPU: compiled with g++ against
tests/cuda_host_shim.h, which emulates the few CUDA features those kernels
use (a thread per CUDA thread, blocks in turn, barriers, shared memory,
cp.async), and held bit for bit to their plain PyTorch versions, under
every tile and every number of points a thread the kernels take, into new
tensors and (the basis change) in place.

This checks the kernels' indexing, staging and order of operations where
there is no card; only chip_smoke.py shows that nvcc builds them and that
they run so on an H100.  Sizes are small: every CUDA thread is a host
thread here.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from arnoldimethod_torch import _device
from arnoldimethod_torch.ops import df

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SHIM = Path(__file__).resolve().parent / "cuda_host_shim.h"


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _top_level_args(text):
    """Split a launch configuration at its top-level commas."""
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
            continue
        depth += ch in "(<"
        depth -= ch in ")>"
        cur += ch
    return out + [cur]


def host_source(cu):
    """df.cu rewritten for the host shim: shared memory as statics (the
    dynamic stage as the shim's buffer), cp.async as emu_copy, launches as
    emu_launch."""
    s = cu.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                   "unsigned char* const smem_raw = ::emu_dynamic_shared;")
    s = s.replace("__shared__", "static")
    s = re.sub(r'asm volatile\("cp\.async\.cg[^;]*?;\\n"[^;]*;',
               "emu_copy(dst, src, 16, src_bytes);(void)d;", s, flags=re.S)
    s = re.sub(r'asm volatile\("cp\.async\.ca[^;]*?;\\n"[^;]*;',
               "emu_copy(dst, src, N, src_bytes);(void)d;", s, flags=re.S)
    s = re.sub(r'asm volatile\("cp\.async\.(commit|wait)[^;]*;\\n"[^;]*;', "",
               s, flags=re.S)
    assert "asm volatile" not in s
    s = re.sub(r"(\b\w+_kernel<[^<>;]*>)\s*<<<(.*?)>>>\s*\((.*?)\);",
               lambda m: "emu_launch(" + ", ".join(_top_level_args(m.group(2))[:2])
               + ", [&] { " + m.group(1) + "(" + m.group(3) + "); });",
               s, flags=re.S)
    assert "<<<" not in s
    return s.replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of df.cu needs g++")
    d = tmp_path_factory.mktemp("df_host")
    src = d / "df_host.cpp"
    src.write_text(host_source(
        (REPO / "arnoldimethod_torch" / "csrc" / "df.cu").read_text()))
    so = d / "libdf_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-Wno-unknown-pragmas", "-o",
                    str(so), str(src)], check=True, capture_output=True,
                   timeout=300)
    out = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int64
    for word in ("_f32", "_f64"):
        f = getattr(out, "df_basis_change" + word)
        f.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, p]
        g = getattr(out, "stencil5_df" + word)
        g.argtypes = [p, p, p, p, i, i, i, p, p]
        f.restype = g.restype = ctypes.c_int
    return out


INTS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(INTS[a.dtype]),
                                              b.view(INTS[b.dtype]))


def _pair(rng, dtype, *shape):
    lo = 2.0 ** (-26 if dtype == torch.float32 else -55)
    return (torch.from_numpy(rng.standard_normal(shape)).to(dtype),
            torch.from_numpy(rng.standard_normal(shape) * lo).to(dtype))


def _word(dtype):
    return "_f32" if dtype == torch.float32 else "_f64"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m1,n,rows", [(61, 130, 61), (61, 97, 31),
                                       (61, 258, 46), (9, 37, 1)])
def test_basis_change_source_is_bitwise(lib, dtype, m1, n, rows):
    """Every tile of the word, a ragged last column tile (n % 4 != 0 takes
    the word-by-word copies), into new tensors and into V itself."""
    rng = np.random.default_rng(m1 + n + rows)
    Vh, Vl = _pair(rng, dtype, m1, n)
    Qh, Ql = _pair(rng, dtype, m1, m1)
    want = df.df_basis_change_plain(Vh, Vl, Qh, Ql, rows)
    fn = getattr(lib, "df_basis_change" + _word(dtype))
    for tile in df._BASIS_TILES[Vh.element_size()]:
        plan = df.basis_plan(m1, n, rows, Vh.element_size(), tile)
        oh = torch.full((rows, n), 7.0, dtype=dtype)
        ol = torch.full_like(oh, 7.0)
        assert fn(Vh.data_ptr(), Vl.data_ptr(), Qh.data_ptr(), Ql.data_ptr(),
                  m1, n, rows, plan.R, plan.C, plan.W, oh.data_ptr(),
                  ol.data_ptr(), None) == 0
        assert _bitwise(oh, want[0]) and _bitwise(ol, want[1]), tile
        assert plan.in_place
        Wh, Wl = Vh.clone(), Vl.clone()
        assert fn(Wh.data_ptr(), Wl.data_ptr(), Qh.data_ptr(), Ql.data_ptr(),
                  m1, n, rows, plan.R, plan.C, plan.W, Wh.data_ptr(),
                  Wl.data_ptr(), None) == 0
        assert _bitwise(Wh[:rows], want[0]) and _bitwise(Wl[:rows], want[1])
        assert _bitwise(Wh[rows:], Vh[rows:]) and _bitwise(Wl[rows:], Vl[rows:])


def test_basis_change_source_refuses_bad_plans(lib):
    V = torch.zeros(4, 8)
    Q = torch.zeros(4, 4)
    fn = lib.df_basis_change_f32
    for rows, R, C, W in ((0, 8, 2, 1), (5, 8, 2, 1), (4, 3, 2, 1),
                          (4, 8, 2, 9)):
        assert fn(V.data_ptr(), V.data_ptr(), Q.data_ptr(), Q.data_ptr(), 4,
                  8, rows, R, C, W, V.data_ptr(), V.data_ptr(), None) != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", [(25, 40), (9, 3), (33, 70)])
def test_stencil_source_is_bitwise(lib, dtype, grid):
    """One, two and four points a thread, ragged tiles at the grid's
    edges."""
    rng = np.random.default_rng(grid[0] * grid[1])
    ny, nx = grid
    xh, xl = _pair(rng, dtype, ny * nx)
    coeffs = (4.3, -1.2, -0.8, -1.0, -1.1)
    want = df.stencil5_df_plain(xh, xl, coeffs, grid)
    words = (ctypes.c_double * 15)(*df.coefficient_words(coeffs, dtype))
    fn = getattr(lib, "stencil5_df" + _word(dtype))
    for P in (1, 2, 4):
        yh, yl = torch.full_like(xh, 7.0), torch.full_like(xl, 7.0)
        assert fn(xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yl.data_ptr(),
                  ny, nx, P, words, None) == 0
        assert _bitwise(yh, want[0]) and _bitwise(yl, want[1]), P
    yh = torch.empty_like(xh)
    assert fn(xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yh.data_ptr(), ny,
              nx, 3, words, None) != 0
