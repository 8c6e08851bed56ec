"""The port's kernels: CUDA C++ sources in ``csrc/``, their wrappers here."""
