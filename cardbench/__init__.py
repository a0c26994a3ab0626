"""The benchmark of arnoldimethod_torch on a CUDA card (see README.md)."""
