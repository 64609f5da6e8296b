"""Faults found in the port against the JAX package, and how each now stands.

1. Spearman's ranks with NaN: the port ranks from one sort's permutation and
   the runs of equal sorted values, NaN last and all NaNs one run, which are
   JAX's ``searchsorted`` ranks (exact, float32). A single row raises
   ``ValueError`` in the functional form, as in JAX.
2. Constant images: on a constant window the port's convolution gives a
   variance of exactly 0 and UQI, SSIM (``data_range=None``) and D-lambda
   give NaN (0/0). JAX's convolution leaves a rounding residue there
   (about -3e-8 at 0.5) and returns 1.0; that value comes from rounding, not
   from the formula, so the port does not imitate it. These tests pin the
   port's NaN; ``ROADMAP.md`` records JAX's value as a reference caveat.
3. Public names: the subpackages export what the JAX package's do.
4. JAX's keywords of the shell: ``load_state_dict(sd, prefix=...)`` reads the
   keys under the prefix, and ``type(dtype=...)`` casts as ``type(dst_type)``;
   torch's own signatures still work.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.functional import spearman_corrcoef as j_spearman
from metrics_tpu.functional.regression.correlation import _rank_data as j_rank
from metrics_tpu_torch.functional import spearman_corrcoef
from metrics_tpu_torch.functional.regression.correlation import _rank_data

NAN = float("nan")
RANK_CASES = {
    "documented": [0.3, NAN, -1.0, 2.0, 0.3],
    "several_nans_and_signed_zeros": [NAN, 0.0, -0.0, NAN, 1.0, -0.0, 2.0, NAN],
    "all_nan": [NAN, NAN, NAN],
    "inf_beside_nan": [float("inf"), NAN, float("-inf"), 1.0, float("inf")],
    "long_ties": np.round(np.random.default_rng(0).random(300), 1).tolist(),
    "no_nan": np.random.default_rng(1).random(50).tolist(),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_ranks_equal_the_reference(case):
    x = np.asarray(RANK_CASES[case], dtype=np.float32)
    got = _rank_data(torch.from_numpy(x))
    want = np.asarray(j_rank(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_documented_nan_ranks():
    got = _rank_data(torch.tensor([0.3, NAN, -1.0, 2.0, 0.3]))
    assert torch.equal(got, torch.tensor([2.5, 5.0, 1.0, 4.0, 2.5]))


def _spearman_rows(seed, n=20):
    rng = np.random.default_rng(seed)
    preds = rng.random(n).astype(np.float32)
    target = (preds + 0.3 * rng.random(n)).astype(np.float32)
    return preds, target


@pytest.mark.parametrize("where", ["preds", "target", "both"])
def test_spearman_with_nan_equals_the_reference(where):
    """Functional and module forms against JAX, within atol 1e-6 (float32 moments in another order)."""
    preds, target = _spearman_rows(4)
    if where in ("preds", "both"):
        preds[[3, 11]] = np.nan
    if where in ("target", "both"):
        target[[5, 11]] = np.nan
    want = float(j_spearman(jnp.asarray(preds), jnp.asarray(target)))
    got = float(spearman_corrcoef(torch.from_numpy(preds), torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isfinite(got)
    mine, ref = tmt.SpearmanCorrCoef(device="cpu"), jmt.SpearmanCorrCoef()
    for lo, hi in ((0, 8), (8, 20)):
        mine.update(torch.from_numpy(preds[lo:hi]), torch.from_numpy(target[lo:hi]))
        ref.update(jnp.asarray(preds[lo:hi]), jnp.asarray(target[lo:hi]))
    np.testing.assert_allclose(float(mine.compute()), float(ref.compute()), rtol=0, atol=1e-6)


def test_single_row_raises_value_error_like_the_reference():
    with pytest.raises(ValueError):
        j_spearman(jnp.asarray([1.0]), jnp.asarray([2.0]))
    with pytest.raises(ValueError, match="1-d"):
        spearman_corrcoef(torch.tensor([1.0]), torch.tensor([2.0]))


# ------------------------------------------------------------ constant images
@pytest.mark.parametrize("level", [0.5, 1.0])
@pytest.mark.parametrize("metric", ["uqi", "ssim", "d_lambda"])
def test_constant_images_give_nan_in_the_port(metric, level):
    """The port's 0/0 on a constant window. JAX returns 1.0 (0.9700772 for
    D-lambda against random targets) because its convolution leaves a
    rounding residue of about -3e-8 in the variance: a value of rounding,
    not of the formula, recorded as a reference caveat and not imitated."""
    const = torch.full((2, 3, 32, 32), level)
    F = tmt.functional
    if metric == "uqi":
        value = F.universal_image_quality_index(const, const.clone())
    elif metric == "ssim":
        value = F.structural_similarity_index_measure(const, const.clone(), data_range=None)
    else:
        target = torch.from_numpy(np.random.default_rng(2).random((2, 3, 32, 32)).astype(np.float32))
        value = F.spectral_distortion_index(const, target)
    assert torch.isnan(value)


# ---------------------------------------------------------------- public names
OPS_NAMES = ["binned_curve_counts", "segment_count", "segment_cumsum", "segment_max", "segment_ranks",
             "segment_starts", "segment_sum", "fused_bincount", "FAULT_SITES", "fault_stats", "inject_faults",
             "reset_warn_dedupe", "set_recovery_policy", "journal_generations", "journal_stats", "journalable",
             "SPAN_SITES", "prometheus_text", "set_telemetry", "telemetry_snapshot"]
UTILS_NAMES = ["rank_zero_info", "rank_zero_debug", "rank_zero_only", "rank_zero_warn", "FaultError", "TraceFault",
               "CompileFault", "RuntimeFault", "DonationFault", "HostOffloadFault", "SyncFault", "SyncConfigFault"]


@pytest.mark.parametrize("name", OPS_NAMES)
def test_ops_exports_the_reference_names(name):
    import metrics_tpu.ops as jops
    import metrics_tpu_torch.ops as tops

    assert name in tops.__all__ and name in jops.__all__
    namespace = {}
    exec(f"from metrics_tpu_torch.ops import {name} as value", namespace)  # noqa: S102 - the import path itself
    assert namespace["value"] is getattr(tops, name)
    module = {"binned_curve_counts": "binned", "fused_bincount": "histogram"}.get(name)
    module = module or ("segments" if name.startswith("segment_") else None)
    if module is not None:
        defining = __import__(f"metrics_tpu_torch.ops.{module}", fromlist=[name])
        assert getattr(defining, name) is namespace["value"]


@pytest.mark.parametrize("name", UTILS_NAMES)
def test_utils_exports_the_reference_names(name):
    import metrics_tpu.utils as jutils
    import metrics_tpu_torch.utils as tutils

    assert name in tutils.__all__ and name in jutils.__all__
    assert getattr(tutils, name) is not None


@pytest.mark.parametrize("level", ["info", "debug"])
def test_rank_zero_log_lines(level, caplog, monkeypatch):
    from metrics_tpu_torch.utils import prints

    fn = getattr(prints, f"rank_zero_{level}")
    with caplog.at_level("DEBUG", logger=prints.log.name):
        fn("hello %s", "there")
    assert [r.getMessage() for r in caplog.records] == ["hello there"]
    caplog.clear()
    monkeypatch.setenv("RANK", "1")
    with caplog.at_level("DEBUG", logger=prints.log.name):
        fn("not on rank 1")
    assert caplog.records == []


def test_top_level_telemetry_names():
    from metrics_tpu_torch.ops import telemetry

    for name in ("telemetry_snapshot", "prometheus_text", "export_trace", "set_telemetry"):
        assert name in tmt.__all__ and hasattr(jmt, name)
        assert getattr(tmt, name) is getattr(telemetry, name)


# ------------------------------------------------- JAX's keywords of the shell
def test_load_state_dict_takes_the_reference_prefix():
    rng = np.random.RandomState(7)
    preds, target = rng.rand(30, 4).astype(np.float32), rng.randint(0, 4, 30)
    src, jsrc = tmt.ConfusionMatrix(num_classes=4, device="cpu"), jmt.ConfusionMatrix(num_classes=4)
    src.persistent(True)
    jsrc.persistent(True)
    src.update(torch.from_numpy(preds), torch.from_numpy(target))
    jsrc.update(jnp.asarray(preds), jnp.asarray(target))
    sd, jsd = src.state_dict(prefix="a."), jsrc.state_dict(prefix="a.")
    assert set(sd) == set(jsd) == {"a.confmat"}
    sd["b.confmat"] = torch.zeros(4, 4, dtype=torch.int64)  # another prefix's key: not read
    dst, jdst = tmt.ConfusionMatrix(num_classes=4, device="cpu"), jmt.ConfusionMatrix(num_classes=4)
    dst.persistent(True)
    jdst.persistent(True)
    dst.load_state_dict(sd, prefix="a.")
    jdst.load_state_dict(jsd, prefix="a.")
    np.testing.assert_array_equal(dst.confmat.numpy(), np.asarray(jdst.confmat))
    assert torch.equal(dst.confmat, src.confmat)
    plain = tmt.ConfusionMatrix(num_classes=4, device="cpu")
    plain.persistent(True)
    plain.load_state_dict(src.state_dict(), strict=True)  # torch's own signature still works
    assert torch.equal(plain.confmat, src.confmat)
    # a persistent state missing under the prefix: each package's own error
    with pytest.raises(RuntimeError):
        dst.load_state_dict(sd, prefix="c.")
    with pytest.raises(KeyError):
        jdst.load_state_dict(jsd, prefix="c.")


@pytest.mark.parametrize("how", ["dtype", "dst_type", "positional"])
def test_type_takes_the_reference_dtype_keyword(how):
    m, jm = tmt.MeanMetric(device="cpu"), jmt.MeanMetric()
    m.update(torch.tensor([1.0, 2.0]))
    jm.update(jnp.asarray([1.0, 2.0]))
    out = {"dtype": lambda: m.type(dtype=torch.float64), "dst_type": lambda: m.type(dst_type=torch.float64),
           "positional": lambda: m.type(torch.float64)}[how]()
    jout = jm.type(dtype=jnp.float16)
    assert out is m and jout is jm
    assert m.value.dtype == torch.float64 and jm.value.dtype == jnp.float16
    assert float(m.compute()) == float(jm.compute()) == 1.5
    with pytest.raises(TypeError):
        m.type()
