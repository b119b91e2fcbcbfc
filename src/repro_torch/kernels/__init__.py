"""Hand-written CUDA kernels for the hot spots, one package each:
``<name>.py`` (build and bind the CUDA source in ``repro_torch/csrc``),
``ops.py`` (wrapper: checks, launch count, plain version for CPU tensors)
and ``ref.py`` (the plain torch version)."""
