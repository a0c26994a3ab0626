"""Where the port's tensors go when the caller names no device.

Every entry point whose input is not already a tensor (operators built from
numpy or scipy arrays, callables, the model problems, workspaces,
`convert.py`, `partial_schur` on such input) resolves `device=None` here:
to the CUDA card, which is what the port is for.  A tensor input keeps its
own device.  Without CUDA, `device=None` raises and names `device="cpu"`;
it never carries on on the CPU unasked.

`DEFAULT` is the device `None` means.  It is "cuda"; a test suite that runs
on the CPU sets it to "cpu" for its own duration.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT", "resolve"]

DEFAULT = "cuda"


def resolve(device=None, like=None):
    """The torch.device for `device`: itself when given; else the device of
    `like` when it is a tensor; else `DEFAULT`.  Makes no allocation and
    does not initialise CUDA.  Raises RuntimeError when the default is the
    card and no card is present."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    dev = torch.device(DEFAULT)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless asked "
            "otherwise; pass device=\"cpu\" to run on the CPU"
        )
    return dev
