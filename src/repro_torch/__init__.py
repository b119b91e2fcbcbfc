"""Raven on PyTorch and CUDA: prediction queries (SQL with ``PREDICT``) over
a model store, a cross optimizer and an eager executor, with the
tree-ensemble GEMM as a hand-written CUDA kernel for Hopper.  The JAX
package ``repro`` is the reference this package is held against."""
