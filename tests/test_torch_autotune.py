"""The port's kernel autotuner (``metrics_tpu_torch/ops/autotune.py``) and its variants against the JAX package's.

Every port variant equals JAX's variant of the same name on the same seeded
numpy inputs, NaN scores and unsorted thresholds included, under the declared
contract: bit for bit for ``binned_counts`` and ``bincount``; 1e-4 for the
sort variants, 1e-2 for ``fid_sqrtm``, 1e-5 for ``map_box_iou``. Then the
plane's contracts: ``shape_class`` spells JAX's keys, the disarmed path is
pinned by its counters, a poisoned or inexact variant is disqualified and the
reference serves, a variant whose kernel cannot run raises out of the sweep, the selection table persists and restores with no sweep,
its digest changes the engine's keys, and a consult under ``torch.func.vmap``
never sweeps.
"""
import json
import os
import warnings

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.detection import mean_ap as jmean_ap
from metrics_tpu.image import generative as jgenerative
from metrics_tpu.ops import autotune as jautotune
from metrics_tpu.ops import sorted_curves as jsorted
from metrics_tpu_torch.detection import mean_ap
from metrics_tpu_torch.image import generative
from metrics_tpu_torch.ops import autotune, binned, engine, faults, histogram, progcache, sorted_curves


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    autotune.configure(reset=True)
    progcache.configure(reset=True)
    engine.reset_stats(reset_warnings=True)
    yield
    autotune.configure(reset=True)
    progcache.configure(reset=True)
    engine.reset_stats(reset_warnings=True)


# ---------------------------------------------------------------- the cases
def _psd(rng, d, spectrum):
    q, _ = np.linalg.qr(rng.randn(d, d))
    return (q * np.asarray(spectrum)[None, :]) @ q.T


def _score_cases():
    rng = np.random.RandomState(7)
    cases = []
    for n in (1, 2, 33, 1024):
        cases.append((rng.rand(n).astype(np.float32), (rng.rand(n) > 0.4).astype(np.float32)))
    cases.append((np.round(rng.rand(512), 2).astype(np.float32), (rng.rand(512) > 0.5).astype(np.float32)))
    zeros = np.zeros(64, np.float32)
    zeros[::2] = -0.0
    cases.append((zeros, (np.arange(64) % 3 == 0).astype(np.float32)))
    cases.append((rng.randn(257).astype(np.float32), (rng.rand(257) > 0.5).astype(np.float32)))
    cases.append((rng.rand(17).astype(np.float32), np.zeros(17, np.float32)))
    cases.append((rng.rand(17).astype(np.float32), np.ones(17, np.float32)))
    nan = np.round(rng.rand(300), 2).astype(np.float32)
    nan[::37] = np.nan
    nan[5] = -np.nan
    cases.append((nan, (rng.rand(300) > 0.5).astype(np.float32)))
    return cases


def _count_cases():
    rng = np.random.RandomState(3)
    return [(np.asarray([], np.int64), 4), (np.asarray([0], np.int64), 1),
            (rng.randint(-5, 40, size=777).astype(np.int64), 32), (rng.randint(0, 8, size=4096).astype(np.int64), 8)]


def _binned_cases():
    rng = np.random.RandomState(11)
    cases = []
    for n, c, t in ((1, 1, 1), (65, 3, 7), (513, 8, 29)):
        cases.append((rng.rand(n, c).astype(np.float32), (rng.rand(n, c) > 0.5).astype(np.float32),
                      rng.rand(t).astype(np.float32)))  # unsorted thresholds
    preds = np.tile(np.linspace(0, 1, 11, dtype=np.float32)[:, None], (1, 2))
    cases.append((preds, (rng.rand(11, 2) > 0.5).astype(np.float32), np.asarray([0.5, 0.0, 1.0, 0.5], np.float32)))
    nan = rng.rand(200, 5).astype(np.float32)
    nan[::13, 1] = np.nan
    nan[3, 2], nan[4, 3] = np.inf, -np.inf
    thr = rng.permutation(np.linspace(0, 1, 17).astype(np.float32))
    thr[6] = np.nan
    cases.append((nan, (rng.rand(200, 5) > 0.3).astype(np.float32), thr))
    return cases


def _sqrtm_cases():
    rng = np.random.RandomState(5)
    cases = []
    for d, spec in ((8, np.linspace(1.0, 2.0, 8)), (16, np.logspace(-3, 0, 16)),
                    (12, np.r_[np.zeros(4), np.linspace(0.5, 1.5, 8)])):
        cases.append((_psd(rng, d, spec), _psd(rng, d, spec[::-1])))
    return cases


def _iou_cases():
    rng = np.random.RandomState(13)

    def boxes(n):
        b = (rng.rand(n, 4) * 64).astype(np.float32)
        b[:, 2:] += b[:, :2]
        return b

    d = boxes(5)
    d[0, 2:] = d[0, :2]  # a zero-area box: the unguarded 0/0 stays NaN on both paths
    return [(boxes(1), boxes(1)), (boxes(13), boxes(7)), (boxes(100), boxes(33)), (d, d.copy())]


CASES = {"auroc_sort": _score_cases, "ap_sort": _score_cases, "bincount": _count_cases,
         "binned_counts": _binned_cases, "fid_sqrtm": _sqrtm_cases, "map_box_iou": _iou_cases}
CONTRACT = {"auroc_sort": 1e-4, "ap_sort": 1e-4, "bincount": None, "binned_counts": None, "fid_sqrtm": 1e-2,
            "map_box_iou": 1e-5}
PAIRS = [(k, v) for k in sorted(CASES) for v in {"auroc_sort": ("midranks", "single_sort", "packed_sort"),
                                                  "ap_sort": ("argsort", "packed_sort"),
                                                  "bincount": ("segment_sum", "scatter_add", "onehot_matmul"),
                                                  "binned_counts": ("onehot_matmul", "scatter_add", "segment_sum"),
                                                  "fid_sqrtm": ("eigh", "newton_schulz"),
                                                  "map_box_iou": ("host_numpy", "device_blocked")}[k]]


def test_the_registry_is_the_reference_registry():
    autotune.load_registrations()
    jautotune.load_registrations()
    assert set(autotune.kernels()) == set(jautotune.kernels()) == set(CASES)
    for kernel in CASES:
        assert autotune.variants(kernel) == jautotune.variants(kernel)
        for name in autotune.variants(kernel):
            mine, ref = autotune._KERNELS[kernel].variants[name], jautotune._KERNELS[kernel].variants[name]
            assert (mine.tolerance, mine.reference, mine.host) == (ref.tolerance, ref.reference, ref.host), name
            assert mine.tolerance == (None if mine.reference else CONTRACT[kernel]) or mine.reference


def _ported(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("kernel,name", PAIRS, ids=[f"{k}-{v}" for k, v in PAIRS])
def test_each_variant_matches_the_reference_package(kernel, name):
    mine = autotune._KERNELS[kernel].variants[name]
    ref = jautotune._KERNELS[kernel].variants[name]
    for case in CASES[kernel]():
        if mine.host:
            got, want = mine.fn(*case), ref.fn(*case)
        elif kernel == "fid_sqrtm":
            with jax.enable_x64(True):
                want = ref.fn(*(jnp.asarray(a) for a in case))
            got = mine.fn(*(_ported(a) for a in case))
        else:
            want = ref.fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in case))
            got = mine.fn(*(_ported(a) for a in case))
        got = [got] if not isinstance(got, tuple) else list(got)
        want = [want] if not isinstance(want, tuple) else list(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            w = np.asarray(w)
            assert g.shape == w.shape, (kernel, name)
            if CONTRACT[kernel] is None:
                assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), (kernel, name)
            else:
                np.testing.assert_allclose(g, w, rtol=CONTRACT[kernel], atol=CONTRACT[kernel], equal_nan=True)


def test_sortable_keys_are_the_reference_keys():
    for preds, _ in _score_cases():
        want = np.asarray(jsorted._sortable_score_keys(jnp.asarray(preds))).astype(np.int64)
        assert np.array_equal(sorted_curves._sortable_score_keys(torch.from_numpy(preds)).numpy(), want)
    assert sorted_curves._SORT_TOL == jsorted._SORT_TOL == 1e-4


def test_shape_class_spells_the_reference_keys():
    cases = [(np.zeros((1000, 1000), np.float32), np.zeros(100, np.float32), np.zeros(7, np.float32)),
             (np.zeros((13, 4), np.float32), np.zeros((0, 4), np.float32)), (np.zeros(777, np.int32), 32),
             (np.zeros((2048, 2048), np.float64),)]
    for args in cases:
        want = jautotune.shape_class(*args)
        assert autotune.shape_class(*args) == want
        assert autotune.shape_class(*(_ported(a) for a in args)) == want
    assert autotune.shape_class(torch.zeros(1000, 1000)) == "float32[1024x1024]"


def test_the_disarmed_path_is_pinned_by_its_counters():
    rng = np.random.RandomState(1)
    preds, target = torch.from_numpy(rng.rand(64, 5).astype(np.float32)), torch.from_numpy((rng.rand(64, 5) > 0.5) * 1.0)
    thr = torch.linspace(0, 1, 9)
    binned.binned_curve_counts(preds, target, thr)
    histogram.fused_bincount(torch.randint(0, 5, (100,)), 5)
    sorted_curves.binary_auroc_sorted(preds[:, 0], target[:, 0])
    sorted_curves.multiclass_average_precision_sorted(preds, torch.randint(0, 5, (64,)), 5)
    assert autotune.enabled() is False and engine._autotune_key is None and engine._autotune_note is None
    assert autotune.dispatch("binned_counts", (preds, target, thr), sweep_on_miss=True) is None
    assert all(v == 0 for v in autotune.autotune_stats().values())
    assert autotune.selection_table() == {}


def test_a_poisoned_variant_is_disqualified_and_the_reference_serves():
    x = torch.from_numpy(np.random.RandomState(4).randint(0, 16, 512))
    autotune.configure(enabled=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faults.inject_faults("autotune-sweep", 2) as plan:
            rep = autotune.sweep("bincount", (x, 16))
    assert plan.fired == 2 and rep["disqualified"] == 2 and rep["winner"] == "segment_sum"
    st = autotune.autotune_stats()
    assert st["autotune_disqualified"] == 2 and st["autotune_installs"] == 1 and st["autotune_sweeps"] == 1
    assert autotune.dispatch("bincount", (x, 16)) is None
    assert torch.equal(histogram.fused_bincount(x, 16), histogram._bincount_segment_sum(x, 16))


def test_a_variant_that_cannot_run_raises_out_of_the_sweep(monkeypatch):
    # a hand kernel that fails to build or launch is no verdict on the variant: the reference must not hide it
    def failed_launch(*args, **kwargs):
        raise RuntimeError("mt_bincount failed to launch: an injected launch error")

    engine.reset_engine()
    monkeypatch.setattr(histogram, "fused_bincount", failed_launch)
    rng = np.random.RandomState(14)
    args = (torch.from_numpy(rng.rand(96, 3).astype(np.float32)),
            torch.from_numpy((rng.rand(96, 3) > 0.5).astype(np.float32)), torch.linspace(0, 1, 5))
    autotune.configure(enabled=True)
    with pytest.raises(RuntimeError, match="failed to launch"):
        autotune.sweep("binned_counts", args)
    with pytest.raises(RuntimeError, match="failed to launch"):
        autotune.dispatch("binned_counts", args, sweep_on_miss=True)
    st = autotune.autotune_stats()
    assert st["autotune_disqualified"] == 0 and st["autotune_installs"] == 0 and autotune.selection_table() == {}
    assert faults.fault_stats()["fault_demotions"] == 0


@pytest.mark.parametrize("case", ["fractional_targets", "nan_scores"])
def test_an_inexact_bucketize_variant_is_disqualified(case):
    rng = np.random.RandomState(6)
    preds = rng.rand(300, 4).astype(np.float32)
    target = rng.rand(300, 4).astype(np.float32) if case == "fractional_targets" else (rng.rand(300, 4) > 0.5) * 1.0
    if case == "nan_scores":
        preds[::7, 0] = np.nan
    args = (torch.from_numpy(preds), torch.from_numpy(target.astype(np.float32)), torch.linspace(0, 1, 21))
    autotune.configure(enabled=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = autotune.sweep("binned_counts", args)
    bucketize = [r for r in rep["candidates"] if r["variant"] in ("scatter_add", "segment_sum")]
    assert all(r["ok"] is False and r["exact"] is False for r in bucketize), rep["candidates"]
    assert rep["winner"] == "onehot_matmul" and rep["disqualified"] == 2
    got = binned.binned_curve_counts(*args)
    want = binned._binned_onehot_matmul(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_an_installed_winner_serves_the_same_counts():
    rng = np.random.RandomState(2)
    args = (torch.from_numpy(rng.rand(400, 6).astype(np.float32)),
            torch.from_numpy((rng.rand(400, 6) > 0.5).astype(np.float32)), torch.linspace(0, 1, 33))
    want = binned.binned_curve_counts(*args)
    autotune.configure(enabled=True)
    autotune._install("binned_counts", autotune.shape_class(*args), "segment_sum")
    got = binned.binned_curve_counts(*args)
    assert autotune.autotune_stats()["autotune_hits"] == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_the_selection_table_persists_and_a_warm_boot_sweeps_nothing(tmp_path):
    progcache.configure(enabled=True, cache_dir=str(tmp_path / "store"))
    autotune.configure(enabled=True)
    x = torch.from_numpy(np.random.RandomState(9).randint(0, 32, 1024))
    autotune.sweep("bincount", (x, 32))
    table = autotune.selection_table()
    path = os.path.join(progcache.cache_dir(), "autotune_selections.json")
    assert table and autotune.autotune_stats()["autotune_persists"] >= 1 and os.path.exists(path)
    doc = json.load(open(path))
    assert doc["magic"] == "MTAT" and doc["selections"] == table
    engine.reset_engine()
    engine.reset_stats(reset_warnings=True)
    autotune.configure(reset=True)
    autotune.configure(enabled=True)
    autotune.dispatch("bincount", (x, 32), sweep_on_miss=True)
    st = autotune.autotune_stats()
    assert st["autotune_sweeps"] == 0 and st["autotune_restores"] >= 1 and autotune.selection_table() == table


def test_a_corrupt_selection_table_demotes_and_the_reference_serves(tmp_path):
    progcache.configure(enabled=True, cache_dir=str(tmp_path / "store"))
    autotune.configure(enabled=True)
    x = torch.from_numpy(np.random.RandomState(10).randint(0, 16, 256))
    autotune.sweep("bincount", (x, 16))
    path = os.path.join(progcache.cache_dir(), "autotune_selections.json")
    doc = json.load(open(path))
    doc["crc"] += 1  # the selections no longer match their CRC
    json.dump(doc, open(path, "w"))
    engine.reset_stats(reset_warnings=True)
    autotune.configure(reset=True)
    autotune.configure(enabled=True)
    with pytest.warns(UserWarning, match="could not restore"):
        assert autotune.dispatch("bincount", (x, 16)) is None
    st = autotune.autotune_stats()
    assert st["autotune_restores"] == 0 and st["autotune_sweeps"] == 0
    assert faults.fault_stats()["fault_journal"] >= 1


def test_the_digest_changes_the_engine_keys():
    autotune.configure(enabled=True)
    d0 = autotune.selection_digest()
    assert engine._autotune_key() == ("autotune", d0)
    build = lambda: (lambda state, x: x + 1)  # noqa: E731
    first = engine.acquire_keyed(("digest-probe",), build)
    assert engine.acquire_keyed(("digest-probe",), build) is first
    autotune.sweep("bincount", (torch.from_numpy(np.random.RandomState(12).randint(0, 8, 128)), 8))
    d1 = autotune.selection_digest()
    assert d1 != d0 and engine._autotune_key() == ("autotune", d1)
    assert engine.acquire_keyed(("digest-probe",), build) is not first


def test_a_consult_under_vmap_never_sweeps():
    autotune.configure(enabled=True)
    det = torch.rand(3, 6, 4) * 10
    det[..., 2:] += det[..., :2]

    def consult(d):
        assert not autotune._concrete((d,))
        assert autotune.dispatch("map_box_iou", (d, d), sweep_on_miss=True) is None
        return d.sum()

    torch.func.vmap(consult)(det)
    assert autotune.autotune_stats()["autotune_sweeps"] == 0


def test_the_map_call_site_sweeps_on_a_miss():
    rng = np.random.RandomState(8)
    det = (rng.rand(12, 4) * 40).astype(np.float32)
    det[:, 2:] += det[:, :2]
    gt = (rng.rand(5, 4) * 40).astype(np.float32)
    gt[:, 2:] += gt[:, :2]
    autotune.configure(enabled=True)
    variant = autotune.dispatch("map_box_iou", (det, gt), sweep_on_miss=True, device="cpu")
    assert autotune.autotune_stats()["autotune_sweeps"] == 1 and variant in (None, "device_blocked")
    out = mean_ap._box_iou_device_blocked(torch.from_numpy(det), torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(out, jmean_ap._box_iou_np(det, gt), rtol=1e-5, atol=1e-5)


def test_fid_takes_the_device_route_and_its_host_counters_stay_zero():
    rng = np.random.RandomState(3)
    real, fake = rng.rand(40, 16).astype(np.float32), rng.rand(40, 16).astype(np.float32)
    m = generative.FrechetInceptionDistance(feature=lambda x: x, device="cpu")
    m.update(torch.from_numpy(real), real=True)
    m.update(torch.from_numpy(fake), real=False)
    value = m.compute()
    assert generative.fid_stats() == {"fid_host_sqrtm": 0, "fid_host_sqrtm_time_s": 0.0}
    assert engine.engine_stats()["fid_host_sqrtm"] == 0
    np.testing.assert_allclose(float(value), jgenerative._fid_from_features_host(real, fake), rtol=1e-6)
