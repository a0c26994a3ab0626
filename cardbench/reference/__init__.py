"""The plain reference that decides `correct`: float64 PyTorch and NumPy,
independent of the program (it imports nothing of arnoldimethod_torch,
arnoldimethod_tpu or jax), working the operator out again from the
configuration's coefficients.  One file per operator kind (its matvec, its
exact spectrum and the control) and one per recipe (the numbers a solve's
answer is judged by)."""

import importlib


def operator_module(spec):
    return importlib.import_module(f"cardbench.reference.{spec['kind']}")


def recipe_module(recipe):
    return importlib.import_module(f"cardbench.reference.{recipe['kind']}")


def round_tf32(x):
    """x (float32) rounded to TF32's 10 stored mantissa bits, to nearest
    (ties away from zero), as the card rounds a TF32 operand."""
    import torch

    i = x.contiguous().view(torch.int32)
    return torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)
