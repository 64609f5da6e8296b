"""The port's host text library against its plain Python programs and the JAX package.

``metrics_tpu_torch/csrc/text_kernels.cpp``, built by ``ops/text_native.py``,
runs the Levenshtein distance (one pair, a batch, the full table), the LCS
length and the EED sentence score. Each is held exactly to the port's plain
Python version of the same program and to the JAX package's functions on
seeded random id sequences and strings, empty ones included; ``intern_ids``
must give the JAX package's ids (TER's shifts compare them). Distances and
lengths are integers and EED is double arithmetic in the same order, so every
comparison here is exact.
"""
import numpy as np
import pytest

from metrics_tpu import native as jax_native
from metrics_tpu.functional.text import eed as jax_eed
from metrics_tpu.functional.text import helper as jax_helper
from metrics_tpu.functional.text import rouge as jax_rouge
from metrics_tpu.functional.text import ter as jax_ter
from metrics_tpu_torch.functional.text import eed as t_eed
from metrics_tpu_torch.functional.text import helper as t_helper
from metrics_tpu_torch.functional.text import rouge as t_rouge
from metrics_tpu_torch.functional.text import ter as t_ter
from metrics_tpu_torch.ops import _native, text_native

SEEDS = range(4)
EED_PARAMS = [(2.0, 0.3, 0.2, 1.0), (0.5, 0.0, 1.0, 0.3)]  # (alpha, rho, deletion, insertion)


def _token_pairs(seed, n=16, vocab=5, max_len=14):
    """Pairs of token lists over a small vocabulary (so matches are frequent), with empty sequences."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(vocab)]
    pairs = []
    for i in range(n):
        la = 0 if i == 0 else int(rng.randint(0, max_len))
        lb = 0 if i == 1 else int(rng.randint(0, max_len))
        pairs.append(([words[k] for k in rng.randint(0, vocab, la)], [words[k] for k in rng.randint(0, vocab, lb)]))
    pairs.append(([], []))
    return pairs


def _char_pairs(seed, n=12):
    """(hypothesis, reference) strings over a few letters and blanks, as EED's preprocessing leaves them."""
    rng = np.random.RandomState(100 + seed)
    letters = list("abcd ")
    out = []
    for i in range(n):
        la, lb = (0, 5) if i == 0 else (int(rng.randint(1, 30)), int(rng.randint(1, 30)))
        out.append(("".join(rng.choice(letters, la)), "".join(rng.choice(letters, lb))))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_intern_ids_equal_jax(seed):
    seqs = [s for pair in _token_pairs(seed) for s in pair]
    for got, want in zip(text_native.intern_ids(*seqs), jax_native.intern_ids(*seqs)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_levenshtein_one_pair(seed):
    for a, b in _token_pairs(seed):
        want = t_helper._edit_distance_plain(a, b)
        assert t_helper._edit_distance(a, b) == want
        assert jax_helper._edit_distance(a, b) == want
        a_ids, b_ids = text_native.intern_ids(a, b)
        assert text_native.levenshtein(a_ids, b_ids) == want  # empty sequences straight into the library too


@pytest.mark.parametrize("seed", SEEDS)
def test_levenshtein_batch(seed):
    pairs = _token_pairs(seed)
    want = [t_helper._edit_distance_plain(a, b) for a, b in pairs]
    assert t_helper._edit_distances(pairs) == want
    assert jax_helper._edit_distances(pairs) == want
    assert t_helper._edit_distances([]) == []
    assert text_native.levenshtein_batch([], []).shape == (0,)


@pytest.mark.parametrize("seed", SEEDS)
def test_levenshtein_table(seed):
    for a, b in _token_pairs(seed):
        want = t_helper._edit_distance_matrix_plain(a, b)
        got = t_helper._edit_distance_matrix(a, b)
        assert got.dtype == np.int32 and got.shape == (len(a) + 1, len(b) + 1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jax_helper._edit_distance_matrix(a, b), want)
        a_ids, b_ids = text_native.intern_ids(a, b)
        np.testing.assert_array_equal(t_ter._edit_distance_table_plain(list(a_ids), list(b_ids)), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_ter_alignment_and_distance_equal_jax(seed):
    for a, b in _token_pairs(seed):
        a_ids, b_ids = (x.tolist() for x in text_native.intern_ids(a, b))
        assert t_ter._edit_distance_with_alignment(a_ids, b_ids) == jax_ter._edit_distance_with_alignment(a_ids, b_ids)
        if a_ids and b_ids:
            assert t_ter._edit_distance_only(a_ids, b_ids) == jax_ter._edit_distance_only(a_ids, b_ids)


@pytest.mark.parametrize("seed", SEEDS)
def test_lcs(seed):
    pairs = _token_pairs(seed)
    want = [t_rouge._lcs_length_plain(a, b) for a, b in pairs]
    assert [t_rouge._lcs_length(a, b) for a, b in pairs] == want
    assert [jax_rouge._lcs_length(a, b) for a, b in pairs] == want
    ids = text_native.intern_ids(*(s for pair in pairs for s in pair))
    assert text_native.lcs_batch(ids[0::2], ids[1::2]).tolist() == want
    for a, b in pairs:  # the LCS alignment (ROUGE-Lsum) stays Python in both packages
        assert t_rouge._lcs_elements(a, b) == jax_rouge._lcs_elements(a, b)


@pytest.mark.parametrize("params", EED_PARAMS)
@pytest.mark.parametrize("seed", SEEDS)
def test_eed(seed, params):
    alpha, rho, deletion, insertion = params
    pairs = _char_pairs(seed)
    want = np.asarray([t_eed._eed_function(h, r, alpha, rho, deletion, insertion) for h, r in pairs])
    got = text_native.eed_batch(
        [text_native.codepoints(h) for h, _ in pairs], [text_native.codepoints(r) for _, r in pairs],
        alpha, rho, deletion, insertion,
    )
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    lib = text_native.load()
    for (h, r), w in zip(pairs, want):
        ph, hh = text_native._as_i32(text_native.codepoints(h))
        pr, rr = text_native._as_i32(text_native.codepoints(r))
        assert lib.mt_eed_score(ph, len(hh), pr, len(rr), 32, alpha, rho, deletion, insertion) == w
    for (h, r), w in zip(pairs, want):
        assert jax_eed._eed_function(h, r, alpha, rho, deletion, insertion) == w


@pytest.mark.parametrize("seed", SEEDS)
def test_eed_update_equals_jax(seed):
    pairs = _char_pairs(seed)
    preds = [h for h, _ in pairs]
    target = [[r, r[::-1]] for _, r in pairs]  # two references: the best of them is kept
    got = t_eed._eed_update(preds, target)
    want = np.asarray([np.asarray(s) for s in jax_eed._eed_update(preds, target)], dtype=np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_codepoints_equal_jax():
    for s in ("", "abc", "日本語 テキスト", "ümlaut ß"):
        np.testing.assert_array_equal(text_native.codepoints(s), jax_native.codepoints(s))


def test_library_is_built_into_the_build_dir_and_counts_its_calls():
    path = text_native.build()
    assert path == text_native.library_path() and path.is_file()
    assert path.parent == _native.BUILD_DIR and path.name.startswith("text_kernels-")
    dp, calls = text_native.DP_CALLS, text_native.LIBRARY_CALLS
    t_helper._edit_distances([(["a"], ["b"]), (["a", "b"], ["b"]), (["c"], [])])
    assert text_native.DP_CALLS == dp + 3 and text_native.LIBRARY_CALLS == calls + 1


def test_batch_length_mismatch_raises():
    with pytest.raises(ValueError, match="as many"):
        text_native.levenshtein_batch([np.zeros(2, np.int32)], [])
    with pytest.raises(ValueError, match="as many"):
        text_native.eed_batch([np.zeros(2, np.int32)], [], 2.0, 0.3, 0.2, 1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_library_equals_the_jax_packages_library(seed):
    """The same ids through both libraries' batch and table calls; where the JAX package's library is not
    built on this machine, its Python fallback gives the values."""
    pairs = _token_pairs(seed)
    ids = text_native.intern_ids(*(s for pair in pairs for s in pair))
    a, b = ids[0::2], ids[1::2]
    if jax_native.available():
        np.testing.assert_array_equal(text_native.levenshtein_batch(a, b), jax_native.levenshtein_batch(a, b))
        np.testing.assert_array_equal(text_native.lcs_batch(a, b), jax_native.lcs_batch(a, b))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(text_native.levenshtein_matrix(x, y), jax_native.levenshtein_matrix(x, y))
        chars = _char_pairs(seed)
        h, r = [text_native.codepoints(x) for x, _ in chars], [text_native.codepoints(y) for _, y in chars]
        np.testing.assert_array_equal(text_native.eed_batch(h, r, 2.0, 0.3, 0.2, 1.0),
                                      jax_native.eed_batch(h, r, 2.0, 0.3, 0.2, 1.0))
    else:
        assert text_native.levenshtein_batch(a, b).tolist() == jax_helper._edit_distances(pairs)
        assert text_native.lcs_batch(a, b).tolist() == [jax_rouge._lcs_length(x, y) for x, y in pairs]


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    (tmp_path / text_native.SOURCE).write_text("int broken( {\n")
    monkeypatch.setattr(text_native, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(text_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        text_native.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-built is left to be loaded
