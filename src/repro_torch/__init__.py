"""PyTorch/CUDA port of the SLIM split-IMEX ocean model.

Mirrors the layout of the JAX package `repro`: `core/` holds the DG
operators and the stepper, `kernels/` the hand-written CUDA kernels (source
in `csrc/`), their plain PyTorch versions and the backend dispatch.  The
port imports `torch` and numpy only.
"""
