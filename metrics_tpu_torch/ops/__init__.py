"""Device kernels: the CUDA bincount (``histogram``) and the loader that builds
the sources under ``csrc/`` (``_native``)."""
from metrics_tpu_torch.ops.histogram import fused_bincount

__all__ = ["fused_bincount"]
