"""Sentence source for recording prompts (host side).

Own copy of the JAX package's ``silent_speech_tpu/capture/book.py``
(reference ``data_collection/read_book.py``: sentences of a text file with
a persistent ``.bookmark`` to resume across sessions). nltk's punkt is not
used: a regex splitter handles the common abbreviations of book text.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "st", "jr", "sr", "vs", "etc",
           "eg", "ie", "no", "vol", "col", "gen", "lt", "capt", "fig"}

_SPLIT_RE = re.compile(r'([.!?]["\')\]]*)\s+(?=["\'(\[]*[A-Z0-9])')


def split_sentences(text: str) -> List[str]:
    """Split running text into sentences (punkt-style heuristics)."""
    text = re.sub(r"\s+", " ", text.strip())
    if not text:
        return []
    pieces: List[str] = []
    start = 0
    for m in _SPLIT_RE.finditer(text):
        end = m.end(1)
        candidate = text[start:end].strip()
        # no split right after an abbreviation such as "Mr."
        last_word = re.findall(r"[A-Za-z]+", candidate[-12:])
        if last_word and last_word[-1].lower() in _ABBREV \
                and candidate.endswith("."):
            continue
        if candidate:
            pieces.append(candidate)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        pieces.append(tail)
    return pieces


class Book:
    """The sentences of a text file with a persistent position in
    ``<file>.bookmark`` (reference ``read_book.py:4-35``). As a context
    manager it writes the bookmark on exit too, so that an interrupted
    session resumes."""

    def __init__(self, filename: str, name: Optional[str] = None):
        self.filename = filename
        self.name = name or os.path.splitext(os.path.basename(filename))[0]
        with open(filename, "r", encoding="utf-8", errors="replace") as f:
            self.sentences = split_sentences(f.read())
        self.bookmark_file = filename + ".bookmark"
        self.position = 0
        if os.path.exists(self.bookmark_file):
            with open(self.bookmark_file) as f:
                self.position = int(f.read().strip() or 0)

    def current_sentence_index(self) -> int:
        return self.position

    def current_sentence(self) -> str:
        return self.sentences[self.position]

    def _write_bookmark(self) -> None:
        with open(self.bookmark_file, "w") as f:
            f.write(str(self.position))

    def advance(self) -> None:
        self.position += 1
        self._write_bookmark()

    def __len__(self) -> int:
        return len(self.sentences)

    def done(self) -> bool:
        return self.position >= len(self.sentences)

    def __enter__(self) -> "Book":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._write_bookmark()
