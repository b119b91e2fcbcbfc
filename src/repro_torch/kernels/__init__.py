"""Hand-written CUDA kernels for the hot spots, one package each:
``<name>.py`` (bind the CUDA source in ``repro_torch/csrc``, built at first
use by ``build.py``), ``ops.py`` (wrapper: checks, launch count, plain
version for CPU tensors, an abstract route for ``meta`` tensors) and
``ref.py`` (the plain torch version).  ``cost.py`` holds the card's peaks
and each kernel's analytic work."""
