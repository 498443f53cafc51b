"""The 37-symbol character set and its codec (reference
``data_utils.py:243-258``); the CTC blank is the index after the last
symbol.

Own copy of ``TextTransform``, ``wer`` and what they call in the JAX
package's ``silent_speech_tpu/text.py``: unidecode-style ASCII folding
(NFKD plus a table of characters it cannot decompose), jiwer's punctuation
removal and lowercasing over ``a-z0-9<space>``, and jiwer's corpus word
error rate.
"""

from __future__ import annotations

import string
import unicodedata
from typing import Iterable, List, Sequence, Union

CHARS = string.ascii_lowercase + string.digits + " "

# Characters NFKD cannot decompose to ASCII; the subset of unidecode's table
# that matters for English book text.
_TRANSLIT = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ß": "ss", "ø": "o", "Ø": "O", "đ": "d", "Đ": "D",
    "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th", "ł": "l", "Ł": "L",
    "—": "-", "–": "-", "―": "-", "‘": "'", "’": "'", "‚": ",",
    "“": '"', "”": '"', "„": '"', "…": "...", "•": "*",
    " ": " ", " ": " ", " ": " ", " ": " ",
    " ": " ", " ": " ",
}


def ascii_transliterate(text: str) -> str:
    """Best-effort Unicode→ASCII folding (unidecode-equivalent for our data)."""
    out: List[str] = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _TRANSLIT:
            out.append(_TRANSLIT[ch])
            continue
        decomp = unicodedata.normalize("NFKD", ch)
        kept = "".join(c for c in decomp if not unicodedata.combining(c))
        out.append("".join(c for c in kept if ord(c) < 128))
    return "".join(out)


def remove_punctuation(text: str) -> str:
    """jiwer.RemovePunctuation semantics: strip ``string.punctuation`` chars."""
    return text.translate(str.maketrans("", "", string.punctuation))


class TextTransform:
    """37-symbol character codec (reference ``data_utils.py:243-258``)."""

    def __init__(self) -> None:
        self.chars = CHARS
        self._index = {c: i for i, c in enumerate(self.chars)}

    def clean_text(self, text: str) -> str:
        text = ascii_transliterate(text)
        text = remove_punctuation(text)
        return text.lower()

    def text_to_int(self, text: str) -> List[int]:
        text = self.clean_text(text)
        return [self._index[c] for c in text]

    def int_to_text(self, ints: Iterable[int]) -> str:
        return "".join(self.chars[i] for i in ints)


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ri != hyp[j - 1])
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return prev[m]


def wer(references: Union[str, Sequence[str]],
        hypotheses: Union[str, Sequence[str]]) -> float:
    """Corpus WER: Σ word edit distances / Σ reference words, as
    ``jiwer.wer`` on lists of sentences (reference
    ``recognition_model.py:58``)."""
    refs = [references] if isinstance(references, str) else list(references)
    hyps = [hypotheses] if isinstance(hypotheses, str) else list(hypotheses)
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references but {len(hyps)} "
                         f"hypotheses")
    total_words = sum(len(r.split()) for r in refs)
    if total_words == 0:
        return 0.0
    return sum(edit_distance(r.split(), h.split())
               for r, h in zip(refs, hyps)) / total_words
