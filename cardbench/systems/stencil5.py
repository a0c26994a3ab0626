"""The program's constant-coefficient 5-point stencil operator."""

import torch


def build(spec, device):
    """arnoldimethod_torch.Stencil5Operator from a configuration's
    `operator` entry, on `device`."""
    from arnoldimethod_torch import Stencil5Operator

    return Stencil5Operator(tuple(spec["coeffs"]), tuple(spec["grid"]),
                            dtype=getattr(torch, spec["dtype"]),
                            boundary=spec["boundary"], device=device)
