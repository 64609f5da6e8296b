"""The networks of the model-backed metrics (JAX counterpart: `metrics_tpu/models/__init__.py`).

InceptionV3 (torch-fidelity's, for FID, KID and IS) and the three LPIPS
networks, as ``nn.Module``s in NCHW.
"""
from metrics_tpu_torch.models.inception import InceptionV3Extractor, params_from_npz
from metrics_tpu_torch.models.lpips import LPIPSExtractor, LPIPSNet

__all__ = ["InceptionV3Extractor", "params_from_npz", "LPIPSExtractor", "LPIPSNet"]
