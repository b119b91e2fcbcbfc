"""Raven on PyTorch and CUDA: prediction queries (SQL with ``PREDICT``) over
a model store, a cross optimizer and an eager executor, and LM serving
(dense, full-attention models through a continuous-batching engine), with
the tree-ensemble GEMM and the flash- and decode-attention kernels
hand-written in CUDA for Hopper.  The JAX package ``repro`` is the
reference this package is held against."""
