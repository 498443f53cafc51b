"""CTC decoding: greedy, and the LM-fused prefix beam search.

Own copy of the JAX package's ``silent_speech_tpu/eval/decode.py`` (the
reference decodes with the third-party ``ctcdecode`` and KenLM,
``recognition_model.py:6,34-35``; α = 1.5, β = 1.85 word-insertion
weights). The word LM is an ARPA file (``ArpaLM``, here) or a KenLM probing
binary (``eval/kenlm_binary.py``). ``beam_ctc_decode`` runs the native
beam search (``utils/native.py``, the C++ in ``native/``), built on first
use, for every LM its context ring holds (order <= 10) and for no LM; a
build that fails raises. ``beam_ctc_decode_plain`` is the same search in
Python: the path of an LM of higher order, and the oracle of the tests.
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import native

LOG10 = math.log(10.0)
NEG_INF = -float("inf")
# the native context ring keeps 9 words (native/arpa_lm.cc kMaxCtx)
NATIVE_MAX_ORDER = 10


def greedy_ctc_decode(log_probs: np.ndarray, blank_id: int,
                      length: Optional[int] = None) -> List[int]:
    """Best-path decode of one utterance: argmax, collapse, strip blanks."""
    ids = np.asarray(log_probs).argmax(axis=-1)
    if length is not None:
        ids = ids[:length]
    out: List[int] = []
    prev = -1
    for i in ids.tolist():
        if i != prev and i != blank_id:
            out.append(i)
        prev = i
    return out


class ArpaLM:
    """Word n-gram LM with back-off, loaded from an ARPA file (.arpa/.gz).

    Scores are natural-log (ARPA stores log10). Unknown words fall back to
    ``<unk>`` if present, else a floor score.
    """

    def __init__(self, path: str, unk_floor: float = -10.0 * LOG10):
        self.ngrams: Dict[int, Dict[Tuple[str, ...],
                                    Tuple[float, float]]] = {}
        self.order = 0
        self.unk_floor = unk_floor
        self.path = path  # lets the native decoder load the same model
        self._load(path)

    def _load(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            section = 0
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    section = int(line[1:line.index("-")])
                    self.order = max(self.order, section)
                    self.ngrams.setdefault(section, {})
                    continue
                if line.startswith("\\") or line.startswith("ngram ") \
                        or line == "\\data\\":
                    if line == "\\end\\":
                        break
                    continue
                if section == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < section + 1:
                        continue
                    logp = float(parts[0])
                    words = tuple(parts[1: 1 + section])
                    backoff = float(parts[1 + section]) \
                        if len(parts) > 1 + section else 0.0
                else:
                    logp = float(parts[0])
                    words = tuple(parts[1].split())
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                self.ngrams[section][words] = (logp * LOG10,
                                               backoff * LOG10)

    def score_word(self, context: Sequence[str], word: str) -> float:
        """log P(word | context) with Katz back-off."""
        context = tuple(context)[-(self.order - 1):] if self.order > 1 \
            else ()
        while True:
            ngram = tuple(context) + (word,)
            entry = self.ngrams.get(len(ngram), {}).get(ngram)
            if entry is not None:
                return entry[0]
            if not context:
                uni = self.ngrams.get(1, {})
                if (word,) in uni:
                    return uni[(word,)][0]
                if ("<unk>",) in uni:
                    return uni[("<unk>",)][0]
                return self.unk_floor
            # back-off: weight of the context ngram + shorter context
            boff = self.ngrams.get(len(context), {}).get(tuple(context))
            backoff_w = boff[1] if boff is not None else 0.0
            return backoff_w + self.score_word(context[1:], word)

    def score_sentence(self, words: Sequence[str]) -> float:
        ctx: List[str] = ["<s>"]
        total = 0.0
        for w in words:
            total += self.score_word(ctx, w)
            ctx.append(w)
        return total


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def native_beam_usable(lm) -> bool:
    """True when ``beam_ctc_decode`` takes the native search for ``lm``:
    no LM, or one of order <= 10 that exposes its file (a KenLM binary
    also its solved layout, which the native side maps)."""
    if lm is None:
        return True
    if getattr(lm, "order", 0) > NATIVE_MAX_ORDER:
        return False
    if getattr(lm, "binary_path", None) is not None:
        return getattr(lm, "layout", None) is not None
    return getattr(lm, "path", None) is not None


def beam_ctc_decode(log_probs: np.ndarray, charset: str, blank_id: int,
                    beam_width: int = 100, lm=None, alpha: float = 1.5,
                    beta: float = 1.85, length: Optional[int] = None,
                    prune_logp: float = -18.0) -> List[int]:
    """Prefix beam search with word-boundary LM fusion (the
    ctcdecode convention the reference uses): a prefix that completes a
    word (space emitted, or the utterance's end) adds
    ``alpha·log P_lm(word | context) + beta``. Natively where
    ``native_beam_usable(lm)``, else ``beam_ctc_decode_plain``."""
    lp = np.asarray(log_probs, dtype=np.float64)
    if length is not None:
        lp = lp[:length]
    if native_beam_usable(lm):
        return native.ctc_beam_decode(lp, charset, blank_id, beam_width,
                                      beta, lm=lm, alpha=alpha,
                                      prune_logp=prune_logp)
    return beam_ctc_decode_plain(lp, charset, blank_id, beam_width, lm,
                                 alpha, beta, prune_logp=prune_logp)


def beam_ctc_decode_plain(log_probs: np.ndarray, charset: str,
                          blank_id: int, beam_width: int = 100,
                          lm=None, alpha: float = 1.5, beta: float = 1.85,
                          space: str = " ", prune_logp: float = -18.0
                          ) -> List[int]:
    """``beam_ctc_decode`` in Python, with the full word history."""
    lp = np.asarray(log_probs, dtype=np.float64)

    def lm_word_bonus(words: Tuple[str, ...], word: str) -> float:
        if lm is None or not word:
            return beta if word else 0.0
        ctx = ("<s>",) + words
        return alpha * lm.score_word(ctx, word) + beta

    # beams: prefix(tuple ints) -> (p_blank, p_nonblank, words, cur_word)
    Beam = Tuple[float, float, Tuple[str, ...], str]
    beams: Dict[Tuple[int, ...], Beam] = {
        (): (0.0, NEG_INF, (), "")}

    for t in range(lp.shape[0]):
        frame = lp[t]
        # prune candidate symbols for speed
        cand = np.where(frame >= frame.max() + prune_logp)[0]
        new_beams: Dict[Tuple[int, ...], Beam] = {}

        def merge(prefix, pb, pnb, words, cur):
            old = new_beams.get(prefix)
            if old is None:
                new_beams[prefix] = (pb, pnb, words, cur)
            else:
                new_beams[prefix] = (
                    _logsumexp2(old[0], pb), _logsumexp2(old[1], pnb),
                    old[2], old[3])

        for prefix, (pb, pnb, words, cur) in beams.items():
            p_total = _logsumexp2(pb, pnb)
            for s in cand.tolist():
                p = float(frame[s])
                if s == blank_id:
                    merge(prefix, p_total + p, NEG_INF, words, cur)
                    continue
                ch = charset[s]
                last = prefix[-1] if prefix else None
                if s == last:
                    # repeat: extend only from blank; stay only from nonblank
                    merge(prefix, NEG_INF, pnb + p, words, cur)
                    new_prefix = prefix + (s,)
                    merge(new_prefix, NEG_INF, pb + p, words, cur + ch)
                else:
                    new_prefix = prefix + (s,)
                    if ch == space:
                        bonus = lm_word_bonus(words, cur)
                        merge(new_prefix, NEG_INF, p_total + p + bonus,
                              words + ((cur,) if cur else ()), "")
                    else:
                        merge(new_prefix, NEG_INF, p_total + p, words,
                              cur + ch)

        scored = sorted(
            new_beams.items(),
            key=lambda kv: -_logsumexp2(kv[1][0], kv[1][1]))
        beams = dict(scored[:beam_width])

    def final_score(entry):
        prefix, (pb, pnb, words, cur) = entry
        s = _logsumexp2(pb, pnb)
        if cur:  # close the trailing word
            s += lm_word_bonus(words, cur)
        return s

    best = max(beams.items(), key=final_score)
    return list(best[0])
