"""The port's pairwise distances against the JAX package on the same inputs.

Cosine, Euclidean, linear and Manhattan, with ``y`` and without (then the
diagonal is zeroed), every reduction, and ``zero_diagonal`` forced both
ways, on rows made with numpy from a seed (N, M <= 40, d = 16). Both
packages take the products in float32 at full precision. Values agree
within atol 1e-5 and rtol 1e-5: Euclidean's expansion ‖x‖² + ‖y‖² - 2x·y
cancels to a few ulps of ‖x‖², about 1e-5 at these norms, and a zero
diagonal of it is exact. Manhattan's row blocks give the same bits as one
block.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as jF
import metrics_tpu_torch.functional as tF
from metrics_tpu_torch.functional.pairwise import distances as tdist

ATOL = RTOL = 1e-5
FNS = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
]


def rows(n, seed, d=16):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def both(fn, x, y=None, **kwargs):
    expected = getattr(jF, fn)(jnp.asarray(x), None if y is None else jnp.asarray(y), **kwargs)
    got = getattr(tF, fn)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kwargs)
    e = np.asarray(expected)
    assert got.dtype == torch.float32 and tuple(got.shape) == e.shape
    atol = ATOL
    if fn == "pairwise_euclidean_distance":
        top = max(float((np.asarray(a, np.float32) ** 2).sum(1).max()) for a in (x, x if y is None else y))
        atol = max(ATOL, float(np.sqrt(16 * np.finfo(np.float32).eps * top)))
    np.testing.assert_allclose(got.numpy(), e, atol=atol, rtol=RTOL)
    return got


@pytest.mark.parametrize("reduction", [None, "mean", "sum", "none"])
@pytest.mark.parametrize("fn", FNS)
def test_with_y(fn, reduction):
    both(fn, rows(24, 1), rows(40, 2), reduction=reduction)


@pytest.mark.parametrize("reduction", [None, "mean"])
@pytest.mark.parametrize("fn", FNS)
def test_without_y_zeroes_the_diagonal(fn, reduction):
    got = both(fn, rows(24, 3), reduction=reduction)
    if reduction is None:
        assert torch.equal(torch.diagonal(got), torch.zeros(24))


@pytest.mark.parametrize("zero_diagonal", [True, False])
@pytest.mark.parametrize("fn", FNS)
def test_zero_diagonal_forced(fn, zero_diagonal):
    x = rows(20, 4)
    both(fn, x, x[:12].copy(), zero_diagonal=zero_diagonal)


def test_zero_diagonal_leaves_the_inputs_alone():
    x = torch.from_numpy(rows(8, 5))
    before = x.clone()
    tF.pairwise_linear_similarity(x, x, zero_diagonal=True)
    assert torch.equal(x, before)


def test_integer_rows_are_taken_as_float32():
    x = np.random.RandomState(6).randint(-5, 5, (10, 6))
    for fn in FNS:
        both(fn, x, x[:4].copy())


def test_products_stay_exact_under_tf32_settings():
    """``high_precision`` holds the float32 product at full precision whatever the caller set."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        both("pairwise_linear_similarity", rows(16, 7), rows(9, 8))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(previous)


def test_manhattan_blocks_give_the_same_bits(monkeypatch):
    x, y = torch.from_numpy(rows(37, 9)), torch.from_numpy(rows(23, 10))
    whole = tF.pairwise_manhattan_distance(x, y)
    monkeypatch.setattr(tdist, "MANHATTAN_BLOCK_BYTES", 5 * 23 * 16 * 4)  # blocks of 5 rows of x
    assert torch.equal(tF.pairwise_manhattan_distance(x, y), whole)


@pytest.mark.parametrize("fn", FNS)
def test_bad_shapes_and_reduction_raise_like_jax(fn):
    for args, kwargs in (((rows(4, 1)[0],), {}), ((rows(4, 1), rows(4, 2, d=3)), {}), ((rows(4, 1),), {"reduction": "max"})):
        with pytest.raises(ValueError):
            getattr(jF, fn)(*[jnp.asarray(a) for a in args], **kwargs)
        with pytest.raises(ValueError):
            getattr(tF, fn)(*[torch.from_numpy(a) for a in args], **kwargs)
