"""The port's text metrics against the JAX package on the same seeded corpora.

Every functional and module form of the WER family, BLEU, SacreBLEU (every
tokenizer this machine can run), chrF, TER, EED, ROUGE, SQuAD, Perplexity,
BERTScore and InfoLM. Corpora are made with numpy from a seed: references
over a small vocabulary with capitals and punctuation, predictions copied
from them with words substituted, inserted and dropped. BERTScore and InfoLM
go through toy models built in both frameworks from one set of numpy
weights (a hashed-free embedding table; for InfoLM an embedding, a context
mean and a linear head over the vocabulary, which is not a transformer).

Tolerances: counts (edits, n-gram counts, lengths, questions) bit for bit;
host-computed scores, which reach float32 at the end, ``HOST_RTOL``; the
device-computed Perplexity, BERTScore and InfoLM ``DEVICE_RTOL`` (float32 sums
over the vocabulary and the width in another order).
"""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu.functional as jF
import metrics_tpu_torch as tmt
import metrics_tpu_torch.functional as tF
from metrics_tpu_torch.utils.data import pack_string_groups, pack_strings, unpack_string_groups, unpack_strings
from metrics_tpu_torch.utils.exceptions import MetricsUserError

jax_infolm = importlib.import_module("metrics_tpu.functional.text.infolm")  # the package exports a function of that name
t_infolm = importlib.import_module("metrics_tpu_torch.functional.text.infolm")

HOST_RTOL = 1e-6  # scores computed on the host in double, rounded to float32 at the end on each side
DEVICE_RTOL = 1e-5  # float32 reductions over the vocabulary / the embedding width in another order
DEVICE_ATOL = 1e-6

WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "fast", "house", "red", "blue", "Paris", "2021",
         "don't", "e.g.", "U.S.", "big", "small", "tree"]
PUNCT = [",", ".", "!", "?", ";", ":"]


def corpus(seed, n=12, multi=False):
    """(preds, targets): targets of 3 to 14 words with some punctuation; preds about 20% edited."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for _ in range(n):
        words = [WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(3, 15))]
        if rng.rand() < 0.5:
            words[-1] = words[-1] + PUNCT[rng.randint(len(PUNCT))]
        target = " ".join(words)
        out = []
        for w in words:
            r = rng.rand()
            if r < 0.07:
                continue  # deletion
            out.append(WORDS[rng.randint(len(WORDS))] if r < 0.14 else w)
            if rng.rand() < 0.06:
                out.append(WORDS[rng.randint(len(WORDS))])  # insertion
        preds.append(" ".join(out))
        if multi:
            alt = " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(2, 10)))
            targets.append([target, alt])
        else:
            targets.append(target)
    return preds, targets


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(got, want, rtol=HOST_RTOL, atol=0.0):
    """``got`` (the port's) against ``want`` (JAX's): same structure, dtypes and values within the tolerance."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for k in want:
            close(got[k], want[k], rtol, atol)
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rtol, atol)
        return
    if isinstance(want, str):
        assert got == want, (got, want)
        return
    if isinstance(want, (float, int)):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        return
    w = np.asarray(want)
    assert isinstance(got, torch.Tensor), type(got)
    g = as_np(got)
    assert g.shape == w.shape and str(g.dtype) == str(w.dtype), (g.shape, w.shape, g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def exact(got, want):
    g, w = as_np(got), np.asarray(want)
    assert g.shape == w.shape and str(g.dtype) == str(w.dtype), (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def same_error(jax_call, torch_call):
    """JAX raises; the port raises the same type with the same message."""
    with pytest.raises(Exception) as jerr:
        jax_call()
    with pytest.raises(type(jerr.value)) as terr:
        torch_call()
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------- strings states
def test_packed_strings_round_trip_and_concatenate():
    a, b = ["héllo wörld", "", "x"], ["日本", "last one"]
    pa, pb = pack_strings(a), pack_strings(b)
    assert pa.dtype == np.uint8 and pa.flags.writeable
    assert unpack_strings(torch.from_numpy(np.concatenate([pa, pb]))) == a + b
    groups = [["a", "b"], [], ["c"]]
    assert unpack_string_groups(torch.from_numpy(pack_string_groups(groups))) == groups
    from metrics_tpu.utils import data as jdata

    np.testing.assert_array_equal(pa, jdata.pack_strings(a))
    np.testing.assert_array_equal(pack_string_groups(groups), jdata.pack_string_groups(groups))


# ------------------------------------------------------------------- WER family
ERROR_RATES = [
    ("word_error_rate", "WordErrorRate"),
    ("char_error_rate", "CharErrorRate"),
    ("match_error_rate", "MatchErrorRate"),
    ("word_information_preserved", "WordInfoPreserved"),
    ("word_information_lost", "WordInfoLost"),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn_name, cls_name", ERROR_RATES)
def test_error_rates(fn_name, cls_name, seed):
    preds, target = corpus(seed)
    close(getattr(tF, fn_name)(preds, target, device="cpu"), getattr(jF, fn_name)(preds, target))
    close(getattr(tF, fn_name)(preds[0], target[0], device="cpu"), getattr(jF, fn_name)(preds[0], target[0]))
    jm, tm = getattr(jmt, cls_name)(), getattr(tmt, cls_name)(device="cpu")
    for sl in (slice(0, 5), slice(5, 12)):
        close(tm(preds[sl], target[sl]), jm(preds[sl], target[sl]))
    close(tm.compute(), jm.compute())
    for name, value in jm.metric_state.items():  # the float32 counts, bit for bit
        exact(getattr(tm, name), value)


def test_error_rate_module_lifecycle():
    preds, target = corpus(3)
    m = tmt.WordErrorRate(device="cpu")
    m.update(preds, target)
    sd = m.state_dict()
    assert set(sd) == set()  # states are not persistent by default, as in JAX
    m.persistent(True)
    assert set(m.state_dict()) == {"errors", "total"}
    m.reset()
    assert float(m.errors) == 0.0 and float(m.total) == 0.0 and m.errors.dtype == torch.float32


def test_text_metrics_default_to_the_card():
    if torch.cuda.is_available():
        assert tF.word_error_rate(["a"], ["a"]).device.type == "cuda"
        assert tmt.BLEUScore().device.type == "cuda"
        return
    with pytest.raises(MetricsUserError):
        tF.word_error_rate(["a"], ["a"])
    with pytest.raises(MetricsUserError):
        tmt.BLEUScore()


# ------------------------------------------------------------------------- BLEU
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram", [1, 2, 4])
def test_bleu(n_gram, smooth):
    preds, target = corpus(4, multi=True)
    close(tF.bleu_score(preds, target, n_gram, smooth, device="cpu"), jF.bleu_score(preds, target, n_gram, smooth))
    weights = [1.0 / (i + 1) for i in range(n_gram)]
    close(tF.bleu_score(preds, target, n_gram, smooth, weights, device="cpu"),
          jF.bleu_score(preds, target, n_gram, smooth, weights))
    jm, tm = jmt.BLEUScore(n_gram, smooth), tmt.BLEUScore(n_gram, smooth, device="cpu")
    for sl in (slice(0, 4), slice(4, 12)):
        close(tm(preds[sl], target[sl]), jm(preds[sl], target[sl]))
    close(tm.compute(), jm.compute())
    for name in ("numerator", "denominator", "preds_len", "target_len"):
        exact(getattr(tm, name), getattr(jm, name))


def test_bleu_zero_match_and_errors():
    close(tF.bleu_score(["a b c"], [["d e f"]], device="cpu"), jF.bleu_score(["a b c"], [["d e f"]]))
    same_error(lambda: jF.bleu_score(["a", "b"], [["a"]]), lambda: tF.bleu_score(["a", "b"], [["a"]], device="cpu"))
    same_error(lambda: jF.bleu_score(["a"], [["a"]], 4, weights=[0.5, 0.5]),
               lambda: tF.bleu_score(["a"], [["a"]], 4, weights=[0.5, 0.5], device="cpu"))
    same_error(lambda: jmt.BLEUScore(2, weights=[1.0]), lambda: tmt.BLEUScore(2, weights=[1.0], device="cpu"))


TOKENIZERS = ["none", "13a", "zh", "intl", "char"]


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("tokenize", TOKENIZERS)
def test_sacre_bleu(tokenize, lowercase):
    preds, target = corpus(5, multi=True)
    preds = [p + " 中文测试" if i % 3 == 0 else p for i, p in enumerate(preds)]
    close(tF.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase, device="cpu"),
          jF.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase))
    jm = jmt.SacreBLEUScore(tokenize=tokenize, lowercase=lowercase)
    tm = tmt.SacreBLEUScore(tokenize=tokenize, lowercase=lowercase, device="cpu")
    jm.update(preds[:6], target[:6])
    tm.update(preds[:6], target[:6])
    jm.update(preds[6:], target[6:])
    tm.update(preds[6:], target[6:])
    close(tm.compute(), jm.compute())
    exact(tm.numerator, jm.numerator)


def test_sacre_bleu_unknown_tokenizer():
    same_error(lambda: jF.sacre_bleu_score(["a"], [["a"]], tokenize="bad"),
               lambda: tF.sacre_bleu_score(["a"], [["a"]], tokenize="bad", device="cpu"))


# ------------------------------------------------------------------------- chrF
CHRF_GRID = [
    dict(),
    dict(n_word_order=0),
    dict(n_char_order=3, n_word_order=1, beta=1.0),
    dict(lowercase=True, whitespace=True),
    dict(beta=3.0, whitespace=True),
]


@pytest.mark.parametrize("kwargs", CHRF_GRID)
def test_chrf(kwargs):
    preds, target = corpus(6, multi=True)
    close(tF.chrf_score(preds, target, **kwargs, device="cpu"), jF.chrf_score(preds, target, **kwargs))
    got = tF.chrf_score(preds, target, **kwargs, return_sentence_level_score=True, device="cpu")
    want = jF.chrf_score(preds, target, **kwargs, return_sentence_level_score=True)
    close(got[0], want[0])
    close(got[1], want[1])
    jm, tm = jmt.CHRFScore(**kwargs), tmt.CHRFScore(**kwargs, device="cpu")
    for sl in (slice(0, 5), slice(5, 12)):
        close(tm(preds[sl], target[sl]), jm(preds[sl], target[sl]))
    close(tm.compute(), jm.compute())
    for name in ("preds_packed", "target_packed"):  # the packed bytes, bit for bit
        exact(torch.cat(getattr(tm, name)), np.concatenate([np.asarray(a) for a in getattr(jm, name)]))


def test_chrf_sentence_level_module_and_errors():
    preds, target = corpus(7, multi=True)
    jm = jmt.CHRFScore(return_sentence_level_score=True)
    tm = tmt.CHRFScore(return_sentence_level_score=True, device="cpu")
    jm.update(preds, target)
    tm.update(preds, target)
    close(tm.compute(), jm.compute())
    same_error(lambda: jF.chrf_score(["a"], [[]]), lambda: tF.chrf_score(["a"], [[]], device="cpu"))
    same_error(lambda: jF.chrf_score(["a"], [["a"]], n_char_order=0),
               lambda: tF.chrf_score(["a"], [["a"]], n_char_order=0, device="cpu"))
    same_error(lambda: jmt.CHRFScore().update(["a", "b"], [["a"]]),
               lambda: tmt.CHRFScore(device="cpu").update(["a", "b"], [["a"]]))


# -------------------------------------------------------------------------- TER
TER_GRID = [
    dict(),
    dict(normalize=True),
    dict(no_punctuation=True, lowercase=False),
    dict(normalize=True, asian_support=True, no_punctuation=True),
]


@pytest.mark.parametrize("kwargs", TER_GRID)
def test_ter(kwargs):
    preds, target = corpus(8, multi=True)
    preds = [p + " 日本語。" if i % 4 == 0 else p for i, p in enumerate(preds)]
    close(tF.translation_edit_rate(preds, target, **kwargs, device="cpu"), jF.translation_edit_rate(preds, target, **kwargs))
    got = tF.translation_edit_rate(preds, target, **kwargs, return_sentence_level_score=True, device="cpu")
    want = jF.translation_edit_rate(preds, target, **kwargs, return_sentence_level_score=True)
    close(got[0], want[0])
    close(got[1], want[1])
    jm = jmt.TranslationEditRate(**kwargs, return_sentence_level_score=True)
    tm = tmt.TranslationEditRate(**kwargs, return_sentence_level_score=True, device="cpu")
    for sl in (slice(0, 5), slice(5, 12)):
        jm.update(preds[sl], target[sl])
        tm.update(preds[sl], target[sl])
    close(tm.compute(), jm.compute())
    exact(tm.total_num_edits, jm.total_num_edits)
    exact(tm.total_tgt_length, jm.total_tgt_length)


def test_ter_shifts_and_errors():
    preds = ["the cat sat on the mat quickly today", "a b c d e f g h"]
    target = [["quickly today the cat sat on the mat"], ["e f g h a b c d"]]
    close(tF.translation_edit_rate(preds, target, device="cpu"), jF.translation_edit_rate(preds, target))
    tm = tmt.TranslationEditRate(device="cpu")
    close(tm(preds, target), jmt.TranslationEditRate()(preds, target))
    same_error(lambda: jF.translation_edit_rate(["a", "b"], [["a"]]),
               lambda: tF.translation_edit_rate(["a", "b"], [["a"]], device="cpu"))
    same_error(lambda: jF.translation_edit_rate(["a"], [["a"]], normalize=1),
               lambda: tF.translation_edit_rate(["a"], [["a"]], normalize=1, device="cpu"))


# -------------------------------------------------------------------------- EED
EED_GRID = [dict(), dict(language="ja"), dict(alpha=1.0, rho=0.5, deletion=0.4, insertion=0.8)]


@pytest.mark.parametrize("kwargs", EED_GRID)
def test_eed(kwargs):
    preds, target = corpus(9, multi=True)
    close(tF.extended_edit_distance(preds, target, **kwargs, device="cpu"),
          jF.extended_edit_distance(preds, target, **kwargs))
    got = tF.extended_edit_distance(preds, target, **kwargs, return_sentence_level_score=True, device="cpu")
    want = jF.extended_edit_distance(preds, target, **kwargs, return_sentence_level_score=True)
    close(got[0], want[0])
    close(got[1], want[1])
    jm = jmt.ExtendedEditDistance(**kwargs, return_sentence_level_score=True)
    tm = tmt.ExtendedEditDistance(**kwargs, return_sentence_level_score=True, device="cpu")
    for sl in (slice(0, 5), slice(5, 12)):
        close(tm(preds[sl], target[sl]), jm(preds[sl], target[sl]))
    close(tm.compute(), jm.compute())


def test_eed_errors_and_empty():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # compute before update
        close(tmt.ExtendedEditDistance(device="cpu").compute(), jmt.ExtendedEditDistance().compute())
    same_error(lambda: jF.extended_edit_distance(["a"], ["a"], language="de"),
               lambda: tF.extended_edit_distance(["a"], ["a"], language="de", device="cpu"))
    same_error(lambda: jF.extended_edit_distance(["a"], ["a"], alpha=1),
               lambda: tF.extended_edit_distance(["a"], ["a"], alpha=1, device="cpu"))
    same_error(lambda: jmt.ExtendedEditDistance(rho=-1.0), lambda: tmt.ExtendedEditDistance(rho=-1.0, device="cpu"))


# ------------------------------------------------------------------------ ROUGE
def multi_sentence(seed, n=8):
    rng = np.random.RandomState(seed)
    preds, target = corpus(seed, n=3 * n)
    join = lambda xs: "\n".join(xs)  # noqa: E731
    cut = [int(c) for c in rng.randint(1, 4, n)]
    p, t, pos = [], [], 0
    for c in cut:
        p.append(join(preds[pos : pos + c]))
        t.append(join(target[pos : pos + c]))
        pos += c
    return p, t


ROUGE_GRID = [
    dict(),
    dict(accumulate="avg"),
    dict(rouge_keys=("rougeL", "rouge1")),
    dict(use_stemmer=True),
    dict(normalizer=lambda s: s.upper(), tokenizer=lambda s: s.split()),
]


@pytest.mark.parametrize("kwargs", ROUGE_GRID)
def test_rouge(kwargs):
    preds, target = multi_sentence(10)
    multi = [[t, t[::-1]] for t in target]
    for tgt in (target, multi):
        close(tF.rouge_score(preds, tgt, **kwargs, device="cpu"), jF.rouge_score(preds, tgt, **kwargs))
    close(tF.rouge_score(preds[0], target[0], **kwargs, device="cpu"), jF.rouge_score(preds[0], target[0], **kwargs))
    jm, tm = jmt.ROUGEScore(**kwargs), tmt.ROUGEScore(**kwargs, device="cpu")
    for sl in (slice(0, 3), slice(3, 8)):
        close(tm(preds[sl], multi[sl]), jm(preds[sl], multi[sl]))
    close(tm.compute(), jm.compute())
    for name, rows in jm.metric_state.items():  # per-sentence scores, one (batch,) row an update
        close(torch.cat(getattr(tm, name)), np.concatenate([np.asarray(r) for r in rows]))


def test_rouge_errors_and_pickle():
    import pickle

    same_error(lambda: jF.rouge_score("a", "a", rouge_keys="rouge3"),
               lambda: tF.rouge_score("a", "a", rouge_keys="rouge3", device="cpu"))
    same_error(lambda: jF.rouge_score("a", "a", accumulate="max"),
               lambda: tF.rouge_score("a", "a", accumulate="max", device="cpu"))
    m = tmt.ROUGEScore(use_stemmer=True, device="cpu")
    m.update("the cats are running", "a cat runs")
    back = pickle.loads(pickle.dumps(m))
    close(back.compute(), m.compute())
    assert back.stemmer is not None


# ------------------------------------------------------------------------ SQuAD
def squad_data(seed, n=20):
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(n):
        answers = [" ".join(WORDS[k] for k in rng.randint(0, len(WORDS), rng.randint(1, 4))) for _ in range(rng.randint(1, 4))]
        pred = answers[0] if rng.rand() < 0.4 else " ".join(WORDS[k] for k in rng.randint(0, len(WORDS), rng.randint(0, 4)))
        preds.append({"prediction_text": pred, "id": f"q{i}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{i}"})
    return preds, target


def test_squad():
    preds, target = squad_data(11)
    close(tF.squad(preds, target, device="cpu"), jF.squad(preds, target))
    close(tF.squad(preds[0], target[0], device="cpu"), jF.squad(preds[0], target[0]))
    jm, tm = jmt.SQuAD(), tmt.SQuAD(device="cpu")
    for sl in (slice(0, 7), slice(7, 20)):
        close(tm(preds[sl], target[sl]), jm(preds[sl], target[sl]))
    close(tm.compute(), jm.compute())
    exact(tm.total, jm.total)
    exact(tm.exact_match, jm.exact_match)
    assert tm.total.dtype == torch.int32
    same_error(lambda: jF.squad([{"prediction_text": "a"}], target[:1]),
               lambda: tF.squad([{"prediction_text": "a"}], target[:1], device="cpu"))
    same_error(lambda: jF.squad(preds[:1], [{"id": "q0"}]), lambda: tF.squad(preds[:1], [{"id": "q0"}], device="cpu"))


# ------------------------------------------------------------------- Perplexity
def logits(seed, shape=(3, 7, 11)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    t = rng.randint(0, shape[-1], shape[:2])
    t[0, :2] = -100
    return x, t


@pytest.mark.parametrize("ignore_index", [None, -100, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_perplexity(dtype, ignore_index):
    x, t = logits(12)
    if ignore_index != -100:  # the padded positions take id 0, or the ignored id
        t = np.where(t < 0, 0 if ignore_index is None else ignore_index, t)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    close(tF.perplexity(tx, torch.from_numpy(t), ignore_index), jF.perplexity(jx, jnp.asarray(t), ignore_index),
          rtol=DEVICE_RTOL)
    jm, tm = jmt.Perplexity(ignore_index), tmt.Perplexity(ignore_index, device="cpu")
    for sl in (slice(0, 1), slice(1, 3)):
        close(tm(tx[sl], torch.from_numpy(t[sl])), jm(jx[sl], jnp.asarray(t[sl])), rtol=DEVICE_RTOL)
    close(tm.compute(), jm.compute(), rtol=DEVICE_RTOL)
    exact(tm.count, jm.count)


def test_perplexity_checks_and_nan_under_mask():
    x, t = logits(13)
    cases = [
        (x[0], t),  # preds not 3-D
        (x, t[0]),  # target not 2-D
        (x[:, :5], t),  # first dims differ
        (x.astype(np.int32), t),  # integer logits
        (x, t.astype(np.float32)),  # float target
    ]
    for px, pt in cases:
        same_error(lambda: jF.perplexity(jnp.asarray(px), jnp.asarray(pt)),
                   lambda: tF.perplexity(torch.from_numpy(px), torch.from_numpy(pt)))
    same_error(lambda: jmt.Perplexity(ignore_index=1.5), lambda: tmt.Perplexity(ignore_index=1.5, device="cpu"))
    # a -inf log-probability at id 0 under an ignored position: NaN in both (mask multiplied, not a where)
    x2 = x.copy()
    x2[0, 0, 0] = -np.inf
    got = tF.perplexity(torch.from_numpy(x2), torch.from_numpy(t), ignore_index=-100)
    want = jF.perplexity(jnp.asarray(x2), jnp.asarray(t), ignore_index=-100)
    assert np.isnan(float(want)) and torch.isnan(got)


# -------------------------------------------------------------------- BERTScore
DIM, MAX_LEN = 16, 12
_VOCAB = {w: i for i, w in enumerate(sorted(set(w for s in WORDS for w in [s.lower()])))}
_TABLE = np.random.RandomState(14).randn(len(_VOCAB) + 3, DIM).astype(np.float32)  # + [CLS], [SEP], unknown


def _toy_ids(sentences):
    ids = np.zeros((len(sentences), MAX_LEN), np.int64)
    mask = np.zeros((len(sentences), MAX_LEN), np.float32)
    for i, s in enumerate(sentences):
        words = [_VOCAB.get(w.lower().strip(",.!?;:"), len(_VOCAB) + 2) for w in s.split()][: MAX_LEN - 2]
        row = [len(_VOCAB)] + words + [len(_VOCAB) + 1]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1.0
    return ids, mask


def jax_forward(sentences):
    ids, mask = _toy_ids(sentences)
    return jnp.asarray(_TABLE)[jnp.asarray(ids)], jnp.asarray(mask)


def torch_forward(sentences):
    ids, mask = _toy_ids(sentences)
    return torch.from_numpy(_TABLE)[torch.from_numpy(ids)], torch.from_numpy(mask)


@pytest.mark.parametrize("batch_size", [3, 64])
def test_bert_score_user_forward(batch_size):
    preds, target = corpus(15)
    preds[2] = ""  # a row of [CLS] [SEP] only
    kw = dict(batch_size=batch_size)
    got = tF.bert_score(preds, target, user_forward_fn=torch_forward, device="cpu", **kw)
    want = jF.bert_score(preds, target, user_forward_fn=jax_forward, **kw)
    close(got, want, rtol=DEVICE_RTOL, atol=DEVICE_ATOL)
    jm = jmt.BERTScore(user_forward_fn=jax_forward, **kw)
    tm = tmt.BERTScore(user_forward_fn=torch_forward, device="cpu", **kw)
    for sl in (slice(0, 5), slice(5, 12)):
        jm.update(preds[sl], target[sl])
        tm.update(preds[sl], target[sl])
    close(tm.compute(), jm.compute(), rtol=DEVICE_RTOL, atol=DEVICE_ATOL)
    close(tF.bert_score(preds[0], target[0], user_forward_fn=torch_forward, device="cpu"),
          jF.bert_score(preds[0], target[0], user_forward_fn=jax_forward), rtol=DEVICE_RTOL, atol=DEVICE_ATOL)


def test_bert_score_zero_special_tokens_and_baseline(tmp_path):
    from metrics_tpu.functional.text import bert as jbert
    from metrics_tpu_torch.functional.text import bert as tbert

    mask = np.array([[1, 1, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]], np.int32)
    exact(tbert._zero_special_tokens(torch.from_numpy(mask)), jbert._zero_special_tokens(jnp.asarray(mask)))
    csv_file = tmp_path / "baseline.csv"
    csv_file.write_text("LAYER,P,R,F\n0,0.1,0.2,0.3\n1,0.4,0.5,0.6\n")
    preds, target = corpus(16, n=4)
    kw = dict(rescale_with_baseline=True, baseline_path=str(csv_file), num_layers=1, return_hash=True)
    close(tF.bert_score(preds, target, user_forward_fn=torch_forward, device="cpu", **kw),
          jF.bert_score(preds, target, user_forward_fn=jax_forward, **kw), rtol=DEVICE_RTOL, atol=DEVICE_ATOL)


def test_bert_score_errors():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        close(tF.bert_score([], [], user_forward_fn=torch_forward, device="cpu"),
              jF.bert_score([], [], user_forward_fn=jax_forward))
    same_error(lambda: jF.bert_score(["a"], ["a", "b"], user_forward_fn=jax_forward),
               lambda: tF.bert_score(["a"], ["a", "b"], user_forward_fn=torch_forward, device="cpu"))
    same_error(lambda: jF.bert_score(["a"], ["a"], model=object()),
               lambda: tF.bert_score(["a"], ["a"], model=object(), device="cpu"))
    same_error(lambda: jF.bert_score(["a"], ["a"], user_forward_fn=jax_forward, idf=True),
               lambda: tF.bert_score(["a"], ["a"], user_forward_fn=torch_forward, idf=True, device="cpu"))
    same_error(lambda: jF.bert_score(["a"], ["a"], user_forward_fn=jax_forward, all_layers=True),
               lambda: tF.bert_score(["a"], ["a"], user_forward_fn=torch_forward, all_layers=True, device="cpu"))
    same_error(lambda: jmt.BERTScore(user_forward_fn=jax_forward).update(["a"], ["a", "b"]),
               lambda: tmt.BERTScore(user_forward_fn=torch_forward, device="cpu").update(["a"], ["a", "b"]))
    m = tmt.BERTScore(user_forward_fn=torch_forward, device="cpu")
    assert m.device.type == "cpu" and not hasattr(m, "device_arg")


# ----------------------------------------------------------------------- InfoLM
class ToyTokenizer:
    """Whitespace tokenizer with the transformers call contract; ids 0-4 are [PAD] [CLS] [SEP] [MASK] [UNK]."""

    pad_token_id, cls_token_id, sep_token_id, mask_token_id = 0, 1, 2, 3
    model_max_length = 512

    def __call__(self, sentences, padding="max_length", max_length=16, truncation=True, return_tensors="np"):
        ids = np.zeros((len(sentences), max_length), np.int64)
        mask = np.zeros((len(sentences), max_length), np.int64)
        for i, s in enumerate(sentences):
            row = [1] + [5 + _VOCAB.get(w.lower().strip(",.!?;:"), -1) if w.lower().strip(",.!?;:") in _VOCAB else 4
                         for w in s.split()] + [2]
            row = row[:max_length]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


MLM_VOCAB = 5 + len(_VOCAB)
_EMB = np.random.RandomState(17).randn(MLM_VOCAB, DIM).astype(np.float32)
_HEAD = (np.random.RandomState(18).randn(DIM, MLM_VOCAB) / 2).astype(np.float32)


class _Config:
    max_length = 10


class _Out:
    def __init__(self, logits):
        self.logits = logits


class JaxMLM:
    config = _Config()

    def __call__(self, input_ids, attention_mask):
        h = jnp.asarray(_EMB)[input_ids]
        m = attention_mask.astype(jnp.float32)[..., None]
        ctx = (h * m).sum(1, keepdims=True) / jnp.maximum(m.sum(1, keepdims=True), 1.0)
        return _Out((h + ctx) @ jnp.asarray(_HEAD))


class TorchMLM(torch.nn.Module):
    config = _Config()

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Parameter(torch.from_numpy(_EMB))
        self.head = torch.nn.Parameter(torch.from_numpy(_HEAD))

    def forward(self, input_ids, attention_mask):
        h = self.emb[input_ids]
        m = attention_mask.to(torch.float32)[..., None]
        ctx = (h * m).sum(1, keepdim=True) / torch.clamp(m.sum(1, keepdim=True), min=1.0)
        return _Out((h + ctx) @ self.head)


INFOLM_GRID = [
    dict(information_measure="kl_divergence", idf=True),
    dict(information_measure="kl_divergence", idf=False, max_length=6),
    dict(information_measure="alpha_divergence", alpha=0.5, idf=False),
    dict(information_measure="beta_divergence", beta=0.5),
    dict(information_measure="ab_divergence", alpha=0.5, beta=0.5),
    dict(information_measure="renyi_divergence", alpha=2.0),
    dict(information_measure="l1_distance"),
    dict(information_measure="l2_distance"),
    dict(information_measure="l_infinity_distance"),
    dict(information_measure="fisher_rao_distance", temperature=1.0),
]


@pytest.mark.parametrize("kwargs", INFOLM_GRID, ids=lambda k: k["information_measure"] + ("_idf" if k.get("idf", True) else ""))
def test_infolm(kwargs):
    preds, target = corpus(19, n=6)
    preds[1] = ""  # specials only: the attention-mask fallback
    got = tF.infolm(preds, target, model=TorchMLM(), user_tokenizer=ToyTokenizer(), batch_size=4, device="cpu",
                    return_sentence_level_score=True, **kwargs)
    want = jF.infolm(preds, target, model=JaxMLM(), user_tokenizer=ToyTokenizer(), batch_size=4,
                     return_sentence_level_score=True, **kwargs)
    if kwargs["information_measure"] == "fisher_rao_distance":
        # 2 arccos(BC) near BC = 1 magnifies the float32 rounding of the Bhattacharyya coefficient BC:
        # hold the coefficient itself, cos(d / 2)
        got, want = [torch.cos(x / 2) for x in got], [jnp.cos(x / 2) for x in want]
    close(got, want, rtol=DEVICE_RTOL, atol=DEVICE_ATOL)


@pytest.mark.parametrize("kwargs", INFOLM_GRID[:3], ids=lambda k: k["information_measure"] + ("_idf" if k.get("idf", True) else ""))
def test_infolm_module(kwargs):
    preds, target = corpus(19, n=6)
    jm = jmt.InfoLM(model=JaxMLM(), user_tokenizer=ToyTokenizer(), batch_size=4, **kwargs)
    tm = tmt.InfoLM(model=TorchMLM(), user_tokenizer=ToyTokenizer(), batch_size=4, device="cpu", **kwargs)
    for sl in (slice(0, 2), slice(2, 6)):
        jm.update(preds[sl], target[sl])
        tm.update(preds[sl], target[sl])
    close(tm.compute(), jm.compute(), rtol=DEVICE_RTOL, atol=DEVICE_ATOL)


EDGE_ROUNDING_FACTOR = 4.0  # the port's float32 error may be this many times JAX's, both against float64


@pytest.mark.parametrize("name, alpha, beta", [
    ("alpha_divergence", 1e-3, None), ("alpha_divergence", 0.999, None), ("alpha_divergence", -2.0, None),
    ("beta_divergence", None, 1e-3), ("beta_divergence", None, -0.999), ("beta_divergence", None, 3.0),
    ("ab_divergence", 1e-3, 2.0), ("ab_divergence", -0.5, 1.0), ("renyi_divergence", 1e-3, None),
    ("renyi_divergence", 5.0, None), ("kl_divergence", None, None), ("fisher_rao_distance", None, None),
])
def test_information_measures_at_their_edges(name, alpha, beta):
    """Near alpha or beta = 0 or 1 the measures divide a difference of sums near 1 by a small number,
    which magnifies float32 rounding in both packages alike: the port is held to the float64 value of
    the same formula within EDGE_ROUNDING_FACTOR times JAX's float32 error (plus 1e-6 of the value),
    and a value one package makes NaN or infinite the other makes so too."""
    rng = np.random.RandomState(20)
    p = rng.rand(5, 40).astype(np.float32)
    p[0, :10] = 0.0  # zeros in the support
    p /= p.sum(-1, keepdims=True)
    q = rng.rand(5, 40).astype(np.float32)
    q /= q.sum(-1, keepdims=True)
    got = t_infolm._InformationMeasure(name, alpha, beta)(torch.from_numpy(p), torch.from_numpy(q))
    want = np.asarray(jax_infolm._InformationMeasure(name, alpha, beta)(jnp.asarray(p), jnp.asarray(q)))
    exact64 = t_infolm._InformationMeasure(name, alpha, beta)(torch.from_numpy(p).double(), torch.from_numpy(q).double())
    got, exact64 = got.numpy(), exact64.numpy()
    assert got.dtype == want.dtype == np.float32
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    bound = EDGE_ROUNDING_FACTOR * np.abs(want - exact64) + 1e-6 * np.abs(exact64) + 1e-7
    assert np.all(np.abs(got - exact64)[finite] <= bound[finite]), (got, want, exact64)


@pytest.mark.parametrize("name, alpha, beta", [
    ("alpha_divergence", 1.0, None), ("alpha_divergence", 0.0, None), ("alpha_divergence", None, None),
    ("beta_divergence", None, 0.0), ("beta_divergence", None, -1.0), ("ab_divergence", 0.5, -0.5),
    ("renyi_divergence", 1, None), ("not_a_measure", None, None),
])
def test_information_measure_checks(name, alpha, beta):
    same_error(lambda: jax_infolm._InformationMeasure(name, alpha, beta),
               lambda: t_infolm._InformationMeasure(name, alpha, beta))


def test_infolm_errors():
    same_error(lambda: jF.infolm(["a"], ["a", "b"], model=JaxMLM(), user_tokenizer=ToyTokenizer()),
               lambda: tF.infolm(["a"], ["a", "b"], model=TorchMLM(), user_tokenizer=ToyTokenizer(), device="cpu"))
    same_error(lambda: jF.infolm(["a"], ["a"], temperature=0.0, model=JaxMLM(), user_tokenizer=ToyTokenizer()),
               lambda: tF.infolm(["a"], ["a"], temperature=0.0, model=TorchMLM(), user_tokenizer=ToyTokenizer(),
                                 device="cpu"))
    same_error(lambda: jF.infolm(["a"], ["a"], model=JaxMLM()),
               lambda: tF.infolm(["a"], ["a"], model=TorchMLM(), device="cpu"))
    same_error(lambda: jmt.InfoLM(model=JaxMLM(), user_tokenizer=ToyTokenizer()).update(["a"], ["a", "b"]),
               lambda: tmt.InfoLM(model=TorchMLM(), user_tokenizer=ToyTokenizer(), device="cpu").update(["a"], ["a", "b"]))


# ------------------------------------------------------------ modules, in common
STRING_MODULES = [
    ("WordErrorRate", {}, False),
    ("BLEUScore", {}, True),
    ("CHRFScore", {}, True),
    ("TranslationEditRate", {}, True),
    ("ExtendedEditDistance", {}, True),
    ("ROUGEScore", {"rouge_keys": ("rouge1", "rougeL")}, True),
]


@pytest.mark.parametrize("cls_name, kwargs, multi", STRING_MODULES, ids=[c for c, _, _ in STRING_MODULES])
def test_module_state_dict_reset_and_forward(cls_name, kwargs, multi):
    preds, target = corpus(21, multi=multi)
    tm = getattr(tmt, cls_name)(**kwargs, device="cpu")
    jm = getattr(jmt, cls_name)(**kwargs)
    close(tm(preds[:6], target[:6]), jm(preds[:6], target[:6]))
    tm.update(preds[6:], target[6:])
    jm.update(preds[6:], target[6:])
    tm.persistent(True)
    sd = tm.state_dict()
    assert sorted(sd) == sorted(jm.metric_state)
    fresh = getattr(tmt, cls_name)(**kwargs, device="cpu")
    fresh.persistent(True)
    fresh.load_state_dict(sd)
    fresh._update_count = tm._update_count
    close(fresh.compute(), jm.compute())
    tm.reset()
    for name, value in tm.metric_state.items():
        assert value == [] if isinstance(value, list) else float(value.sum()) == 0.0, name


def test_collection_of_text_metrics_syncs_in_one_world():
    """WER, BLEU and chrF in one collection: in a world of one, a forced sync keeps every state."""
    preds, target = corpus(22, multi=True)
    suite = tmt.MetricCollection({"wer": tmt.WordErrorRate(device="cpu"), "bleu": tmt.BLEUScore(device="cpu"),
                                  "chrf": tmt.CHRFScore(device="cpu")}, compute_groups=False)
    flat = [t[0] for t in target]
    suite["wer"].update(preds, flat)
    suite["bleu"].update(preds, target)
    suite["chrf"].update(preds, target)
    before = {(k, n): (torch.cat(v) if isinstance(v, list) else v).clone()
              for k, m in suite.items() for n, v in m.metric_state.items()}
    suite.sync(distributed_available=lambda: True)
    for (k, n), v in before.items():
        got = getattr(suite[k], n)
        got = torch.cat(got) if isinstance(got, list) else got
        assert got.dtype == v.dtype and torch.equal(got, v), (k, n)
    suite.unsync()
    want_wer = jmt.WordErrorRate()
    want_wer.update(preds, flat)
    close(suite.compute()["wer"], want_wer.compute())
