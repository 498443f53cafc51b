"""KenLM ``lm.binary`` (probing format, version 5) reader.

Own copy of the JAX package's ``silent_speech_tpu/eval/kenlm_binary.py``.
The reference's recognition eval is defined by a KenLM *binary* LM
(the reference's ``recognition_model.py:34-35`` passes ``lm.binary`` to
ctcdecode). KenLM's binary serialization is a memory-mapped image of its
in-RAM structures; the PROBING variant (the ``build_binary`` default, and
what ships as DeepSpeech's ``lm.binary``) is:

    [Sanity header][FixedWidthParameters][counts u64 × order]  (ALIGN8)
    [vocab header u64][vocab probing table: {u64 hash, u32 id} × buckets]
    [unigram array: {f32 prob, f32 backoff} × (counts[0] + 1)]
    [per middle order 2..N-1: probing table {u64 key, f32 prob, f32 bo}]
    [longest order: probing table {u64 key, f32 prob}]
    [optional vocab strings: NUL-separated words in id order]

Keys: word strings hash with MurmurHash64A(seed=0); ``<unk>`` is always
id 0 and is not stored in the vocab table. N-gram keys chain word ids
newest-word-first through KenLM's CombineWordHash. Probing tables use
linear probing with ``buckets = max(entries + 1, multiplier × entries)``
and 0 as the empty-slot sentinel.

Robustness contract: a file either loads with all
structural checks passing — magic, version, model type, exact file-size
arithmetic, and (when word strings are present) a full vocab-hash
round-trip — or raises :class:`KenLMBinaryError` with the parsed metadata.
It never silently mis-parses, and callers must never fall back to LM-free
decoding without surfacing the failure.

Scores are returned in natural log (KenLM stores log10) to match
:class:`~.decode.ArpaLM`.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LOG10 = math.log(10.0)

MAGIC_PREFIX = b"mmap lm http://kheafield.com/code format version"
MAGIC_V5 = MAGIC_PREFIX + b" 5\n\x00"
_SANITY_MAGIC_BYTES = 56  # ALIGN8(sizeof("…version 5\n\0") = 53)
_SANITY_SIZE = 88  # magic[56] + 3×f32 + 2×u32 + pad + u64
_PARAMS_SIZE = 20  # u8 order (+3 pad) + f32 multiplier + i32 type
#                    + u8 has_vocab (+3 pad) + u32 search_version

MODEL_TYPE_NAMES = {
    0: "PROBING", 1: "REST_PROBING", 2: "TRIE", 3: "QUANT_TRIE",
    4: "ARRAY_TRIE", 5: "QUANT_ARRAY_TRIE",
}

# KenLM lm/search_hashed.hh detail::CombineWordHash constants
_COMBINE_MUL = 8978948897894561157
_COMBINE_XOR_MUL = 17894857484156487943
_U64 = (1 << 64) - 1


class KenLMBinaryError(RuntimeError):
    """A KenLM binary file failed a structural check (clear, loud)."""


def _align8(x: int) -> int:
    return -(-x // 8) * 8


def murmur_hash64a(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A — KenLM's util::MurmurHashNative on 64-bit hosts
    (seed 0 for vocabulary hashing)."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ ((len(data) * m) & _U64)) & _U64
    n8 = len(data) // 8
    for (k,) in struct.iter_unpack("<Q", data[: n8 * 8]):
        k = (k * m) & _U64
        k ^= k >> r
        k = (k * m) & _U64
        h ^= k
        h = (h * m) & _U64
    tail = data[n8 * 8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _U64
    h ^= h >> r
    h = (h * m) & _U64
    h ^= h >> r
    return h


def combine_word_hash(current: int, word_id: int) -> int:
    """KenLM detail::CombineWordHash (lm/search_hashed.hh)."""
    return (((current * _COMBINE_MUL) & _U64)
            ^ (((1 + word_id) * _COMBINE_XOR_MUL) & _U64))


def ngram_hash(word_ids: Sequence[int]) -> int:
    """Key for an n-gram: start at the newest word's id, chain backwards
    (KenLM's hashed search walks the context most-recent-first)."""
    h = word_ids[-1] & _U64
    for w in reversed(word_ids[:-1]):
        h = combine_word_hash(h, w)
    return h


def _buckets(entries: int, multiplier: float) -> int:
    return max(entries + 1, int(multiplier * float(entries)))


def is_kenlm_binary(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC_PREFIX)) == MAGIC_PREFIX
    except OSError:
        return False


class _ProbingTable:
    """Read-only view of a KenLM probing hash table (linear probing,
    key 0 = empty)."""

    def __init__(self, keys: np.ndarray, values: np.ndarray):
        self.keys = keys
        self.values = values
        self.n = len(keys)

    def find(self, key: int) -> Optional[int]:
        i = key % self.n
        keys = self.keys
        for _ in range(self.n):
            k = int(keys[i])
            if k == key:
                return i
            if k == 0:
                return None
            i += 1
            if i == self.n:
                i = 0
        return None


class KenLMBinary:
    """Word n-gram LM loaded from a KenLM probing ``.binary`` file.

    API-compatible with :class:`~.decode.ArpaLM` (``order``,
    ``score_word(context, word)`` in natural log, ``score_sentence``).
    """

    def __init__(self, path: str):
        self.path = path
        self.binary_path = path  # marks this as a binary LM for decode glue
        self.order = 0
        self.counts: List[int] = []
        self._unk_id = 0
        self._word_ids: Dict[str, int] = {}
        self._load(path)

    # -------------------- parsing --------------------------------------
    def _load(self, path: str) -> None:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            data = np.fromfile(f, dtype=np.uint8)
        buf = data.tobytes()

        if buf[: len(MAGIC_PREFIX)] != MAGIC_PREFIX:
            raise KenLMBinaryError(
                f"{path}: not a KenLM binary file (bad magic); "
                "pass an ARPA (.arpa/.gz) model instead")
        if buf[: len(MAGIC_V5)] != MAGIC_V5:
            head = buf[:64].split(b"\x00")[0].decode("ascii", "replace")
            raise KenLMBinaryError(
                f"{path}: unsupported KenLM binary version (header "
                f"{head!r}); only format version 5 is supported — "
                "re-export the model as ARPA")

        off = _SANITY_SIZE
        order, = struct.unpack_from("<B", buf, off)
        multiplier, = struct.unpack_from("<f", buf, off + 4)
        model_type, = struct.unpack_from("<i", buf, off + 8)
        has_vocab, = struct.unpack_from("<B", buf, off + 12)
        if model_type != 0:
            name = MODEL_TYPE_NAMES.get(model_type, f"#{model_type}")
            raise KenLMBinaryError(
                f"{path}: KenLM model type {name} is not supported (only "
                "PROBING); rebuild with `build_binary probing` or export "
                "to ARPA")
        if not (1 <= order <= 10) or not (1.0 <= multiplier <= 100.0):
            raise KenLMBinaryError(
                f"{path}: implausible header (order={order}, "
                f"probing_multiplier={multiplier}) — corrupt file?")
        off += _PARAMS_SIZE
        counts = list(struct.unpack_from(f"<{order}Q", buf, off))
        off += 8 * order
        off = _align8(off)
        self.order = order
        self.counts = counts
        self.probing_multiplier = multiplier

        # ---- layout solve: the few historical layout degrees of freedom
        # (unigram +0/+1 slot, vocab-section ALIGN8) are disambiguated by
        # requiring the section arithmetic to land exactly on EOF (or on
        # the start of a parseable strings blob when has_vocabulary).
        vocab_buckets = _buckets(counts[0], multiplier)
        candidates = []
        for uni_extra in (1, 0):
            for vocab_align in (True, False):
                o = off + 8  # vocab header (u64 bound)
                vt = o
                o += vocab_buckets * 12
                if vocab_align:
                    o = _align8(o)
                ug = o
                o += (counts[0] + uni_extra) * 8
                mids = []
                for n in range(2, order):
                    b = _buckets(counts[n - 1], multiplier)
                    mids.append((o, b))
                    o += b * 16
                lt, lb = None, 0
                if order >= 2:
                    lb = _buckets(counts[order - 1], multiplier)
                    lt = o
                    o += lb * 12
                candidates.append((uni_extra, vocab_align, vt, ug, mids,
                                   lt, lb, o))
        match = None
        for cand in candidates:
            end = cand[-1]
            if end == size and not has_vocab:
                match = cand
                break
            if has_vocab and end <= size:
                tail = buf[end:]
                if tail.endswith(b"\x00") or len(tail) == 0:
                    match = cand
                    break
        if match is None:
            raise KenLMBinaryError(
                f"{path}: section arithmetic does not match the file size "
                f"(order={order}, counts={counts}, "
                f"multiplier={multiplier}, size={size}); the file may be "
                "truncated or from an incompatible KenLM build — export "
                "to ARPA instead")
        (self._uni_extra, _va, vt, ug, mids, lt, lb, end) = match
        # resolved section offsets/buckets — the native decoder mmaps the
        # same file against this layout (native/probing_lm.cc), so only one
        # parser of the format exists
        self.layout = {
            "vocab_off": vt, "vocab_buckets": vocab_buckets,
            "uni_off": ug, "uni_entries": counts[0] + self._uni_extra,
            "mid": list(mids),  # [(offset, buckets)] for orders 2..N-1
            "longest_off": lt if lt is not None else 0,
            "longest_buckets": lb,
        }

        # ---- vocab probing table {u64 hash, u32 id}, 12-byte entries
        ventries = np.frombuffer(
            buf, dtype=np.dtype([("key", "<u8"), ("id", "<u4")],
                                align=False),
            count=vocab_buckets, offset=vt)
        self._vocab = _ProbingTable(ventries["key"].copy(),
                                    ventries["id"].copy())

        # ---- unigram {f32 prob, f32 backoff} indexed by word id
        uni = np.frombuffer(buf, dtype="<f4",
                            count=2 * (counts[0] + self._uni_extra),
                            offset=ug).reshape(-1, 2)
        self._unigram = uni.astype(np.float32)

        # ---- middle tables (orders 2..order-1) {u64, f32, f32}
        self._middle: List[_ProbingTable] = []
        mid_dtype = np.dtype([("key", "<u8"), ("prob", "<f4"),
                              ("bo", "<f4")], align=False)
        for (o, b) in mids:
            e = np.frombuffer(buf, dtype=mid_dtype, count=b, offset=o)
            self._middle.append(_ProbingTable(
                e["key"].copy(),
                np.stack([e["prob"], e["bo"]], axis=-1).astype(np.float32)))

        # ---- longest-order table {u64, f32}
        self._longest: Optional[_ProbingTable] = None
        if lt is not None:
            e = np.frombuffer(
                buf, dtype=np.dtype([("key", "<u8"), ("prob", "<f4")],
                                    align=False),
                count=lb, offset=lt)
            self._longest = _ProbingTable(e["key"].copy(),
                                          e["prob"].astype(np.float32))

        # ---- vocab strings (id order, NUL-separated) + hash self-check
        if has_vocab and end < size:
            words = buf[end:].split(b"\x00")
            if words and words[-1] == b"":
                words.pop()
            self._check_vocab_strings(path, words)
        elif has_vocab:
            raise KenLMBinaryError(
                f"{path}: header declares a stored vocabulary but the "
                "strings section is empty — truncated file?")

    def _check_vocab_strings(self, path: str, words: List[bytes]) -> None:
        """Every stored word must round-trip through the hash table; this
        validates the hash function and table layout against real data."""
        next_id = 1
        misses = 0
        for w in words:
            ws = w.decode("utf-8", "replace")
            if ws in ("<unk>", "<UNK>"):
                self._word_ids[ws] = 0
                continue
            idx = self._vocab.find(murmur_hash64a(w))
            if idx is None:
                misses += 1
                if misses > 0:
                    raise KenLMBinaryError(
                        f"{path}: stored vocab word {ws!r} does not hash "
                        "to a vocab-table hit — hash/layout mismatch; "
                        "refusing to mis-score. Export the model to ARPA.")
            else:
                self._word_ids[ws] = int(self._vocab.values[idx])
            next_id += 1

    # -------------------- queries --------------------------------------
    def word_id(self, word: str) -> int:
        cached = self._word_ids.get(word)
        if cached is not None:
            return cached
        idx = self._vocab.find(murmur_hash64a(word.encode("utf-8")))
        wid = 0 if idx is None else int(self._vocab.values[idx])
        self._word_ids[word] = wid
        return wid

    def _lookup(self, ids: Sequence[int]) -> Optional[Tuple[float, float]]:
        """(log10 prob, log10 backoff) for an n-gram of word ids."""
        n = len(ids)
        if n == 1:
            row = self._unigram[ids[0]]
            return float(row[0]), float(row[1])
        if n == self.order:
            if self._longest is None:
                return None
            i = self._longest.find(ngram_hash(ids))
            return None if i is None else (
                float(self._longest.values[i]), 0.0)
        tbl = self._middle[n - 2]
        i = tbl.find(ngram_hash(ids))
        return None if i is None else (float(tbl.values[i][0]),
                                       float(tbl.values[i][1]))

    def score_word(self, context: Sequence[str], word: str) -> float:
        """Natural-log P(word | context) with Katz back-off — the same
        semantics as ArpaLM.score_word. OOV words resolve to id 0, i.e.
        they score as ``<unk>`` (KenLM's behavior)."""
        ctx = [self.word_id(w) for w in context][-(self.order - 1):] \
            if self.order > 1 else []
        wid = self.word_id(word)
        backoff_acc = 0.0
        while True:
            hit = self._lookup(ctx + [wid])
            if hit is not None:
                return (backoff_acc + hit[0]) * LOG10
            if not ctx:  # unreachable: unigram lookups always hit
                return (backoff_acc
                        + float(self._unigram[wid][0])) * LOG10
            bo = self._lookup(ctx)
            if bo is not None:
                backoff_acc += bo[1]
            ctx = ctx[1:]

    def score_sentence(self, words: Sequence[str]) -> float:
        ctx: List[str] = ["<s>"]
        total = 0.0
        for w in words:
            total += self.score_word(ctx, w)
            ctx.append(w)
        return total


def load_lm(path: str):
    """Load an LM by file type: KenLM probing binary or ARPA text.

    Raises (never silently returns None) when the file is missing or
    unreadable — the reference's eval crashes without its LM too
    (``recognition_model.py:34-35``)."""
    from .decode import ArpaLM

    if not os.path.exists(path):
        raise FileNotFoundError(
            f"language model not found: {path!r} (set --lm_path to a "
            "KenLM probing .binary or an ARPA .arpa/.gz file)")
    if is_kenlm_binary(path):
        return KenLMBinary(path)
    lm = ArpaLM(path)
    if lm.order <= 0:
        raise KenLMBinaryError(
            f"{path}: neither a KenLM binary nor a parseable ARPA file")
    return lm
