"""Every docstring example in ``metrics_tpu_torch`` runs and prints what it shows.

The examples run on the CPU (they pass ``device="cpu"``), so they exercise the
plain PyTorch paths; the CUDA kernel is held to those on the card by
``chip_smoke.py``.
"""
import doctest
import importlib
import pkgutil

import pytest

import metrics_tpu_torch


def _module_names():
    names = ["metrics_tpu_torch"]
    names += [m.name for m in pkgutil.walk_packages(metrics_tpu_torch.__path__, prefix="metrics_tpu_torch.")]
    return sorted(names)


def test_every_export_has_an_example():
    import inspect

    import metrics_tpu_torch.functional as functional

    missing = [
        name
        for name in metrics_tpu_torch.__all__
        if inspect.isclass(getattr(metrics_tpu_torch, name)) or inspect.isfunction(getattr(metrics_tpu_torch, name))
        if ">>>" not in (getattr(metrics_tpu_torch, name).__doc__ or "")
    ]
    missing += [f"functional.{n}" for n in functional.__all__ if ">>>" not in (getattr(functional, n).__doc__ or "")]
    assert not missing, f"exports without a docstring example: {missing}"


@pytest.mark.parametrize("module_name", _module_names())
def test_docstring_examples(module_name):
    module = importlib.import_module(module_name)
    result = doctest.testmod(module, optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE, verbose=False)
    assert result.failed == 0, f"{result.failed} of {result.attempted} examples failed in {module_name}"
