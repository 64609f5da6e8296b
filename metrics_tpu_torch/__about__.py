__version__ = "0.1.0"
__author__ = "metrics-tpu developers"
__license__ = "Apache-2.0"
__docs__ = (
    "PyTorch and CUDA port of metrics_tpu for NVIDIA Hopper: the classification "
    "suite on torch tensors, with hand-written CUDA kernels where the TPU package "
    "had Pallas kernels."
)

__all__ = ["__version__", "__author__", "__license__", "__docs__"]
