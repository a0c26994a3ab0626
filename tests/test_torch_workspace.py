"""The port's ArnoldiWorkspace: it owns its basis, validates shapes, and
shares the JAX package's .npz checkpoint format in both directions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu as jam
from arnoldimethod_torch import ArnoldiWorkspace
from arnoldimethod_torch.workspace import as_torch_dtype
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def test_copy_on_construct():
    V0 = torch.zeros((4, 6), dtype=torch.float64)
    ws = ArnoldiWorkspace(6, 3, dtype=torch.float64, V=V0)
    ws.V[0, 0] = 1.0
    assert V0[0, 0].item() == 0.0
    Vn = np.zeros((4, 6), dtype=np.float32)
    ws = ArnoldiWorkspace(6, 3, V=Vn)
    ws.V[0, 0] = 1.0
    assert Vn[0, 0] == 0.0 and ws.dtype == torch.float32


@pytest.mark.parametrize(
    "dtype,host", [(torch.float32, np.float64), (torch.complex64, np.complex128)]
)
def test_allocation(dtype, host):
    ws = ArnoldiWorkspace(10, 4, dtype=dtype)
    assert tuple(ws.V.shape) == (5, 10) and ws.dtype == dtype
    assert ws.H.shape == (5, 4) and ws.H.dtype == host
    assert ws.device.type == "cpu"


def test_validation():
    with pytest.raises(ValueError):
        ArnoldiWorkspace(5, 10)
    with pytest.raises(ValueError):
        ArnoldiWorkspace(5, 0)
    with pytest.raises(ValueError):
        ArnoldiWorkspace(6, 3, V=np.zeros((3, 6)))
    with pytest.raises(ValueError):
        ArnoldiWorkspace(6, 3, H=np.zeros((3, 3)))


def test_port_checkpoint_loads_in_jax(tmp_path):
    rng = np.random.default_rng(0)
    ws = ArnoldiWorkspace(8, 3, dtype=torch.float32,
                          V=rng.standard_normal((4, 8)),
                          H=rng.standard_normal((4, 3)))
    path = tmp_path / "port.npz"
    ws.save(path)
    jws = jam.ArnoldiWorkspace.load(path)
    assert jws.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(jws.V), ws.V.numpy())
    np.testing.assert_array_equal(jws.H, ws.H)
    back = ArnoldiWorkspace.load(path)
    assert torch.equal(back.V, ws.V) and np.array_equal(back.H, ws.H)


def test_extended_checkpoint_is_refused(tmp_path):
    """An extended checkpoint loads (tests/test_torch_extended.py), and so
    does a split-complex one (tests/test_torch_split_complex.py); one that
    carries both is refused: no solve writes double-word split-complex
    state."""
    jws = jam.ArnoldiWorkspace(8, 3, dtype=jnp.float32)
    jws.Vlo = jnp.zeros_like(jws.V)
    jws.Vim = jnp.zeros_like(jws.V)
    path = tmp_path / "ext.npz"
    jws.save(path)
    with pytest.raises(ValueError, match="Vim"):
        ArnoldiWorkspace.load(path)


@pytest.mark.parametrize(
    "given,want",
    [
        (torch.float32, torch.float32),
        (np.float64, torch.float64),
        ("complex64", torch.complex64),
        (jnp.float32, torch.float32),
    ],
)
def test_as_torch_dtype(given, want):
    assert as_torch_dtype(given) == want
