"""Functional metrics: plain functions on tensors (JAX counterpart: `metrics_tpu/functional`)."""
from metrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from metrics_tpu_torch.functional.classification import __all__ as _classification_all
from metrics_tpu_torch.functional.image import *  # noqa: F401,F403
from metrics_tpu_torch.functional.image import __all__ as _image_all
from metrics_tpu_torch.functional.pairwise import *  # noqa: F401,F403
from metrics_tpu_torch.functional.pairwise import __all__ as _pairwise_all
from metrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from metrics_tpu_torch.functional.regression import __all__ as _regression_all
from metrics_tpu_torch.functional.retrieval import *  # noqa: F401,F403
from metrics_tpu_torch.functional.retrieval import __all__ as _retrieval_all

__all__ = list(_classification_all) + list(_image_all) + list(_pairwise_all) + list(_regression_all) + list(_retrieval_all)
