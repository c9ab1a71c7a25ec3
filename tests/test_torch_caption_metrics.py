"""The port's caption metrics (`rga3_tpu_torch/evaluation/caption_metrics.py`)
against the JAX package's, exactly (`==`): BLEU-4, ROUGE-L, CIDEr-D, METEOR
(its alignment too), METEOR(exact), `evaluate_captions` and the
multiple-choice letter accuracy, on fixed strings and on word strings that
hypothesis draws. METEOR runs with nltk's Porter stemmer and with both
packages' stemmer set to exact matching (a machine without nltk).
"""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rga3_tpu.evaluation import caption_metrics as jcm
from rga3_tpu_torch.evaluation import caption_metrics as tcm

HYPS = ["a cat sits on the mat", "the dog runs fast", "two birds on a wire",
        "The man, riding a bicycle!", "", "the cats running"]
REFS = [["a cat sits on the mat", "there is a cat on the mat"], ["a dog runs very fast"],
        ["two small birds sit on a wire", "birds on a wire"], ["a man rides a bike"],
        ["nothing at all"], ["the cat runs"]]
METRICS = ("bleu4", "rouge_l", "cider_d", "meteor", "meteor_lite")

WORDS = st.sampled_from(["a", "the", "cat", "cats", "dog", "runs", "running", "ran", "red",
                         "on", "mat", "is", "moving", "left", "right", "ball", "balls",
                         "Jumps", "jumped", "over", "ellipse", "ellipses", "."])
SENT = st.lists(WORDS, min_size=0, max_size=9).map(" ".join)
CORPUS = st.lists(st.tuples(SENT, st.lists(SENT, min_size=1, max_size=3)),
                  min_size=1, max_size=4)


@pytest.fixture(params=["porter", "exact"])
def stemmer(request, monkeypatch):
    if request.param == "exact":
        monkeypatch.setattr(jcm, "_STEMMER", lambda t: t)
        monkeypatch.setattr(tcm, "_STEMMER", tcm._exact)
    return request.param


@pytest.mark.parametrize("name", METRICS)
def test_fixed_strings_equal_jax(name, stemmer):
    assert getattr(tcm, name)(HYPS, REFS) == getattr(jcm, name)(HYPS, REFS)
    for h, r in zip(HYPS, REFS):
        assert getattr(tcm, name)([h], [r]) == getattr(jcm, name)([h], [r])


def test_evaluate_captions_and_alignment_equal_jax(stemmer):
    assert tcm.evaluate_captions(HYPS, REFS) == jcm.evaluate_captions(HYPS, REFS)
    sim = lambda h, r: float(len(set(h.split()) & set(r.split())))  # noqa: E731
    assert (tcm.evaluate_captions(HYPS, REFS, sentence_similarity_fn=sim)
            == jcm.evaluate_captions(HYPS, REFS, sentence_similarity_fn=sim))
    for h, r in zip(HYPS, REFS):
        for stages in (("exact",), ("exact", "stem"), ("exact", "stem", "synonym")):
            got = tcm.meteor_align(tcm.tokenize(h), tcm.tokenize(r[0]), stages)
            assert got == jcm.meteor_align(jcm.tokenize(h), jcm.tokenize(r[0]), stages)
    # the stem stage matches morphology with the stemmer, nothing more without it
    score = tcm.meteor(["the cats running"], [["the cat runs"]])
    assert (score > 0.9) == (stemmer == "porter")
    assert tcm.meteor_stages()["stem"] == stemmer


@settings(max_examples=60, deadline=None, database=None)
@given(corpus=CORPUS)
def test_drawn_strings_equal_jax(corpus):
    hyps = [h for h, _ in corpus]
    refs = [r for _, r in corpus]
    assert tcm.evaluate_captions(hyps, refs) == jcm.evaluate_captions(hyps, refs)


@settings(max_examples=40, deadline=None, database=None)
@given(corpus=CORPUS)
def test_drawn_strings_equal_jax_without_stemmer(corpus):
    hyps = [h for h, _ in corpus]
    refs = [r for _, r in corpus]
    saved = jcm._STEMMER, tcm._STEMMER
    jcm._STEMMER, tcm._STEMMER = (lambda t: t), tcm._exact
    try:
        assert tcm.meteor(hyps, refs) == jcm.meteor(hyps, refs)
    finally:
        jcm._STEMMER, tcm._STEMMER = saved


PREDS = ["(A)", "B) something", "The answer is (C).", "Zebra", "", "a.", "(b) lower", "D"]
ANSWERS = ["(A)", "B)", "(C)", "(D)", "(A)", "A", "(B)", "(D) the last"]


def test_multiple_choice_accuracy_equals_jax():
    assert (tcm.multiple_choice_accuracy(PREDS, ANSWERS)
            == jcm.multiple_choice_accuracy(PREDS, ANSWERS))
    for p, a in zip(PREDS, ANSWERS):
        assert tcm.multiple_choice_accuracy([p], [a]) == jcm.multiple_choice_accuracy([p], [a])
    assert tcm.multiple_choice_accuracy([], []) == jcm.multiple_choice_accuracy([], []) == 0.0
