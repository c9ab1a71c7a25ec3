"""Caption metrics (BLEU-4, ROUGE-L, CIDEr-D, METEOR) and the
multiple-choice letter accuracy: the port's own copy of
`rga3_tpu/evaluation/caption_metrics.py`, numpy only.

  * BLEU-4: corpus-level, uniform weights, brevity penalty against the
    closest reference length;
  * ROUGE-L: F-beta with beta = 1.2 over the longest common subsequence;
  * CIDEr-D: tf-idf 1-4-gram cosine with a Gaussian length penalty (sigma
    6), clipped counts, scaled by 10;
  * METEOR: staged unigram alignment (exact -> Porter stem -> WordNet
    synonym), longest contiguous runs first, Fmean = PR / (aP + (1-a)R) and
    the fragmentation penalty g (chunks / matches)^b at a = 0.9, b = 3,
    g = 0.5. The stem stage needs `nltk` and matches exactly without it; the
    synonym stage needs nltk's WordNet corpus and never fires without it.
    Which stage ran is logged when it is first resolved (`meteor_stages`
    names both): a machine without nltk scores METEOR by exact and synonym
    matching alone. `meteor_lite` is the exact stage only.

`HFSentenceSimilarity` is the MiniLM sentence similarity (mean pooling,
L2 norm, dot product) over a local Hugging Face encoder; `transformers` is
imported when one is built.
"""
from __future__ import annotations

import logging
import math
import os
import re
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

_log = logging.getLogger(__name__)
_PUNCT = re.compile(r"[^\w\s]")


def tokenize(s: str) -> List[str]:
    return _PUNCT.sub(" ", s.lower()).split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


# ---------------------------------------------------------------- BLEU
def bleu4(
    hypotheses: Sequence[str], references: Sequence[Sequence[str]]
) -> float:
    """Corpus BLEU-4 with closest-ref-length brevity penalty."""
    clipped = np.zeros(4)
    totals = np.zeros(4)
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        h = tokenize(hyp)
        rs = [tokenize(r) for r in refs]
        hyp_len += len(h)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, 5):
            hc = _ngrams(h, n)
            max_ref = Counter()
            for r in rs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += max(sum(hc.values()), 0)
            clipped[n - 1] += sum(
                min(c, max_ref.get(g, 0)) for g, c in hc.items()
            )
    precisions = np.where(totals > 0, clipped / np.maximum(totals, 1), 0.0)
    if (precisions == 0).any():
        # smooth: standard epsilon to avoid log(0) on short corpora
        precisions = np.maximum(precisions, 1e-9)
    log_p = np.mean(np.log(precisions))
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return float(bp * math.exp(log_p))


# ---------------------------------------------------------------- ROUGE-L
def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
    for i, x in enumerate(a, 1):
        for j, y in enumerate(b, 1):
            dp[i, j] = (
                dp[i - 1, j - 1] + 1 if x == y
                else max(dp[i - 1, j], dp[i, j - 1])
            )
    return int(dp[-1, -1])


def rouge_l(
    hypotheses: Sequence[str], references: Sequence[Sequence[str]],
    beta: float = 1.2,
) -> float:
    scores = []
    for hyp, refs in zip(hypotheses, references):
        h = tokenize(hyp)
        best = 0.0
        for r in refs:
            rt = tokenize(r)
            lcs = _lcs_len(h, rt)
            if lcs == 0:
                continue
            prec = lcs / len(h) if h else 0.0
            rec = lcs / len(rt) if rt else 0.0
            if prec + rec > 0:
                f = ((1 + beta**2) * prec * rec) / (rec + beta**2 * prec)
                best = max(best, f)
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


# ---------------------------------------------------------------- CIDEr-D
def cider_d(
    hypotheses: Sequence[str], references: Sequence[Sequence[str]],
    sigma: float = 6.0,
) -> float:
    n_docs = len(references)
    doc_freq: List[Counter] = [Counter() for _ in range(4)]
    ref_grams = []
    for refs in references:
        per_ref = []
        seen = [set() for _ in range(4)]
        for r in refs:
            rt = tokenize(r)
            grams = [_ngrams(rt, n) for n in range(1, 5)]
            per_ref.append((rt, grams))
            for n in range(4):
                seen[n].update(grams[n].keys())
        for n in range(4):
            for g in seen[n]:
                doc_freq[n][g] += 1
        ref_grams.append(per_ref)

    def tfidf(grams: Counter, n: int):
        vec = {}
        norm = 0.0
        length = max(sum(grams.values()), 1)
        for g, c in grams.items():
            df = max(doc_freq[n].get(g, 0), 1)
            idf = math.log(max(n_docs, 1)) - math.log(df)
            v = (c / length) * idf
            vec[g] = v
            norm += v * v
        return vec, math.sqrt(norm)

    scores = []
    for hyp, per_ref in zip(hypotheses, ref_grams):
        ht = tokenize(hyp)
        h_grams = [_ngrams(ht, n) for n in range(1, 5)]
        score_n = np.zeros(4)
        for rt, rgrams in per_ref:
            delta = len(ht) - len(rt)
            penalty = math.exp(-(delta**2) / (2 * sigma**2))
            for n in range(4):
                hv, hn = tfidf(h_grams[n], n)
                rv, rn = tfidf(rgrams[n], n)
                num = sum(
                    min(hv.get(g, 0), rv.get(g, 0)) * rv.get(g, 0)
                    for g in hv
                )
                if hn > 0 and rn > 0:
                    score_n[n] += penalty * num / (hn * rn)
        score_n /= max(len(per_ref), 1)
        scores.append(10.0 * float(np.mean(score_n)))
    return float(np.mean(scores)) if scores else 0.0


# ---------------------------------------------------------------- METEOR
_STEMMER = None


def _exact(tok: str) -> str:
    return tok


def _stem(tok: str) -> str:
    global _STEMMER
    if _STEMMER is None:
        try:
            from nltk.stem import PorterStemmer
        except ImportError:
            _STEMMER = _exact
            _log.info("METEOR stem stage: exact matching (no nltk)")
        else:
            _STEMMER = PorterStemmer().stem
            _log.info("METEOR stem stage: nltk's Porter stemmer")
    return _STEMMER(tok)


_WORDNET = None


def _synsets(tok: str) -> frozenset:
    """WordNet synset names of `tok`; empty when nltk or its WordNet corpus
    is absent (the synonym stage then never fires)."""
    global _WORDNET
    if _WORDNET is None:
        try:
            from nltk.corpus import wordnet

            wordnet.synsets("test")  # raises LookupError without the corpus
            _WORDNET = wordnet
            _log.info("METEOR synonym stage: nltk's WordNet")
        except (ImportError, LookupError):
            _WORDNET = False
            _log.info("METEOR synonym stage: off (no WordNet corpus)")
    if not _WORDNET:
        return frozenset()
    return frozenset(s.name() for s in _WORDNET.synsets(tok))


def meteor_stages() -> Dict[str, str]:
    """Which METEOR stages can match here: {"stem": "porter" | "exact",
    "synonym": "wordnet" | "off"}."""
    _stem("")
    _synsets("test")
    return {"stem": "exact" if _STEMMER is _exact else "porter",
            "synonym": "wordnet" if _WORDNET else "off"}


def _align_stage(h, r, h_used, r_used, eq):
    """Match unmatched unigrams under `eq`, longest contiguous runs first
    (the official aligner searches for the fewest chunks)."""
    pairs = []
    nh, nr = len(h), len(r)
    while True:
        best = None
        for i in range(nh):
            if h_used[i]:
                continue
            for j in range(nr):
                if r_used[j] or not eq(h[i], r[j]):
                    continue
                length = 1
                while (
                    i + length < nh and j + length < nr
                    and not h_used[i + length] and not r_used[j + length]
                    and eq(h[i + length], r[j + length])
                ):
                    length += 1
                if best is None or length > best[0]:
                    best = (length, i, j)
        if best is None:
            break
        length, i, j = best
        for k in range(length):
            h_used[i + k] = True
            r_used[j + k] = True
            pairs.append((i + k, j + k))
    return pairs


def meteor_align(h: Sequence[str], rt: Sequence[str],
                 stages: Sequence[str] = ("exact", "stem", "synonym")):
    """Staged alignment; returns (pairs sorted by hyp index, chunks)."""
    h_used = [False] * len(h)
    r_used = [False] * len(rt)
    pairs: List = []
    for stage in stages:
        if stage == "exact":
            eq = lambda a, b: a == b  # noqa: E731
        elif stage == "stem":
            eq = lambda a, b: _stem(a) == _stem(b)  # noqa: E731
        elif stage == "synonym":
            eq = lambda a, b: (  # noqa: E731
                a == b or bool(_synsets(a) & _synsets(b))
            )
        else:
            raise ValueError(f"unknown METEOR stage {stage!r}")
        pairs.extend(_align_stage(h, rt, h_used, r_used, eq))
    pairs.sort()
    chunks = 0
    prev = None
    for i, j in pairs:
        if prev is None or i != prev[0] + 1 or j != prev[1] + 1:
            chunks += 1
        prev = (i, j)
    return pairs, chunks


def meteor(
    hypotheses: Sequence[str], references: Sequence[Sequence[str]],
    alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5,
    stages: Sequence[str] = ("exact", "stem", "synonym"),
) -> float:
    """METEOR over the staged alignment (module docstring). Several
    references: the best score a hypothesis, averaged."""
    scores = []
    for hyp, refs in zip(hypotheses, references):
        h = tokenize(hyp)
        best = 0.0
        for r in refs:
            rt = tokenize(r)
            if not h or not rt:
                continue
            pairs, chunks = meteor_align(h, rt, stages)
            m = len(pairs)
            if m == 0:
                continue
            p = m / len(h)
            rcl = m / len(rt)
            fmean = p * rcl / (alpha * p + (1 - alpha) * rcl)
            penalty = gamma * (chunks / m) ** beta
            best = max(best, fmean * (1 - penalty))
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


def meteor_lite(
    hypotheses: Sequence[str], references: Sequence[Sequence[str]],
    alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5,
) -> float:
    """Exact-match METEOR (no stem or synonym stage), matching each
    hypothesis token to its first unused reference token."""
    scores = []
    for hyp, refs in zip(hypotheses, references):
        h = tokenize(hyp)
        best = 0.0
        for r in refs:
            rt = tokenize(r)
            matches = 0
            used = [False] * len(rt)
            chunks = 0
            prev_matched_j = -2
            for tok in h:
                for j, rtok in enumerate(rt):
                    if not used[j] and tok == rtok:
                        used[j] = True
                        matches += 1
                        if j != prev_matched_j + 1:
                            chunks += 1
                        prev_matched_j = j
                        break
            if matches == 0:
                continue
            p = matches / len(h)
            rcl = matches / len(rt)
            fmean = p * rcl / (alpha * p + (1 - alpha) * rcl)
            frag = chunks / matches
            score = fmean * (1 - gamma * frag**beta)
            best = max(best, score)
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


class HFSentenceSimilarity:
    """MiniLM sentence similarity: a Hugging Face encoder, attention-masked
    mean pooling, L2 normalisation, dot product. Takes any local
    sentence-encoder directory (all-MiniLM-L6-v2 for VideoInfer); runs on
    the CPU."""

    def __init__(self, model_name_or_path: str, local_files_only: bool = False):
        from transformers import AutoModel, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(
            model_name_or_path, local_files_only=local_files_only)
        self.model = AutoModel.from_pretrained(
            model_name_or_path, local_files_only=local_files_only)
        self.model.eval()

    def _embed(self, text: str):
        enc = self.tokenizer(
            [text], padding=True, truncation=True, return_tensors="pt"
        )
        with torch.no_grad():
            out = self.model(**enc)[0]  # (1, L, D)
        mask = enc["attention_mask"].unsqueeze(-1).float()
        emb = (out * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
        emb = torch.nn.functional.normalize(emb, p=2, dim=1)
        return emb[0]

    def __call__(self, hypothesis: str, reference: str) -> float:
        return float(
            torch.dot(self._embed(hypothesis), self._embed(reference))
        )


def default_sentence_similarity() -> Optional[Callable]:
    """all-MiniLM-L6-v2 from RGA3_MINILM_DIR or the local HF cache (no
    download is attempted); None when no local encoder exists."""
    path = os.environ.get("RGA3_MINILM_DIR")
    if path and os.path.isdir(path):
        return HFSentenceSimilarity(path)
    try:
        return HFSentenceSimilarity("sentence-transformers/all-MiniLM-L6-v2",
                                    local_files_only=True)
    except Exception:  # no transformers, or no cached encoder
        return None


def evaluate_captions(
    hypotheses: Sequence[str],
    references: Sequence[Sequence[str]],
    sentence_similarity_fn: Optional[Callable] = None,
) -> Dict[str, float]:
    out = {
        "BLEU-4": bleu4(hypotheses, references),
        "ROUGE-L": rouge_l(hypotheses, references),
        "CIDEr": cider_d(hypotheses, references),
        "METEOR": meteor(hypotheses, references),
        "METEOR(exact)": meteor_lite(hypotheses, references),
    }
    if sentence_similarity_fn is not None:
        sims = [
            max(sentence_similarity_fn(h, r) for r in refs)
            for h, refs in zip(hypotheses, references)
        ]
        out["SentenceSim"] = float(np.mean(sims))
    return out


# ---------------------------------------------------------------- MC accuracy
def multiple_choice_accuracy(
    predictions: Sequence[str], answers: Sequence[str]
) -> float:
    """Letter-match accuracy: the letter of "(X)" first, then of "X)", then
    the first character (periods dropped), compared case-insensitively."""

    def extract(s: str) -> str:
        m = re.search(r"\(([A-Z])\)", s)
        if m:
            return m.group(1)
        m = re.search(r"([A-Z])\)", s)
        if m:
            return m.group(1)
        s = s.replace(".", "")
        return s[0] if s else ""

    correct = 0
    for pred, ans in zip(predictions, answers):
        correct += int(extract(pred).lower() == extract(ans).lower())
    return correct / max(len(predictions), 1)
