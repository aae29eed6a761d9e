"""Plain PyTorch version of the RMSNorm kernel: ``models/layers.py``
``rms_norm``, as in the reference."""
from ...models.layers import rms_norm as rmsnorm_ref  # noqa: F401
