"""Hand-written Hopper kernels, one folder each: ``ops.py`` is the
wrapper the model calls, ``ref.py`` the plain PyTorch version of the same
function, and the CUDA source lives in ``repro_torch/csrc``."""
