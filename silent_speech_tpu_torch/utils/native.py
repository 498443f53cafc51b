"""The native CTC beam search and FLAC decoder: their build and their
ctypes bindings.

Own copy of the JAX package's native library
(``silent_speech_tpu/utils/native.py``): the sources in
``silent_speech_tpu_torch/native/`` (the prefix beam search without an LM,
the ARPA and KenLM-probing word LMs, the LM-fused beam search and the FLAC
decoder) compile with ``g++ -O3 -std=c++17 -fPIC -shared`` into
``build/native/libssp_native-<hash>.so`` at the root of the checkout, at
first use. The hash covers the sources and the flags, and the library is
written under a temporary name and renamed into place, so processes that
build at the same time never load a half-written file. A build that fails
raises with the compiler's messages; nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("ctc_beam.cc", "arpa_lm.cc", "probing_lm.cc", "flac_codec.cc")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None
_lm_handles = {}

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "ssp_ctc_beam_decode": (ctypes.c_int32, [
        _c_double_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        _c_int32_p, ctypes.c_int32]),
    "ssp_lm_load": (ctypes.c_int64, [ctypes.c_char_p]),
    "ssp_lm_score_word": (ctypes.c_double, [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p]),
    "ssp_lm_load_probing": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _c_int64_p, _c_int64_p,
        ctypes.c_int64, ctypes.c_int64]),
    "ssp_ctc_beam_decode_lm": (ctypes.c_int32, [
        ctypes.c_int64, _c_double_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_char_p, _c_int32_p, ctypes.c_int32]),
    "ssp_flac_decode": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_int64, _c_int32_p, _c_int32_p,
        ctypes.POINTER(_c_float_p)]),
    "ssp_free": (None, [ctypes.c_void_p]),
}
# ssp_flac_decode's error codes (native/flac_codec.cc)
FLAC_TRUNCATED = -8
FLAC_ERRORS = {-1: "not a FLAC stream", -2: "no STREAMINFO block",
               -3: "reserved block size", -4: "reserved sample size",
               -5: "bad subframe", -6: "reserved channel assignment",
               -7: "out of memory", FLAC_TRUNCATED: "truncated FLAC stream",
               -9: "lost frame sync"}


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*")):
        if path.suffix in (".cc", ".h"):
            digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"libssp_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless their library exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp),
           *(str(SOURCE_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native beam search and FLAC "
                           f"decoder failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def get_lib() -> ctypes.CDLL:
    """The library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _lm_handle(lm) -> int:
    """The native handle of an ``ArpaLM`` or ``KenLMBinary``, loaded once
    per file."""
    lib = get_lib()
    path = getattr(lm, "binary_path", None) or lm.path
    with _lock:
        if path in _lm_handles:
            return _lm_handles[path]
        if getattr(lm, "binary_path", None) is not None:
            lay = lm.layout
            mids = lay["mid"] or [(0, 0)]
            handle = lib.ssp_lm_load_probing(
                path.encode(), lm.order, lay["uni_entries"],
                lay["vocab_off"], lay["vocab_buckets"], lay["uni_off"],
                (ctypes.c_int64 * len(mids))(*(o for o, _ in mids)),
                (ctypes.c_int64 * len(mids))(*(b for _, b in mids)),
                lay["longest_off"], lay["longest_buckets"])
        else:
            handle = lib.ssp_lm_load(path.encode())
        if handle == 0:
            raise ValueError(f"the native library could not load the LM "
                             f"{path}")
        _lm_handles[path] = handle
        return handle


def lm_score_word(lm, context: List[str], word: str) -> float:
    """Natural-log P(word | context) from the native copy of ``lm``."""
    return get_lib().ssp_lm_score_word(
        _lm_handle(lm), " ".join(context).encode(), word.encode())


def ctc_beam_decode(log_probs: np.ndarray, charset: str, blank_id: int,
                    beam_width: int, beta: float, lm=None,
                    alpha: float = 0.0, prune_logp: float = -18.0
                    ) -> List[int]:
    """Prefix beam search over (T, K) log-probs; with ``lm``, word
    scores fused at word boundaries as ``alpha·log P + beta``, else
    ``beta`` a word."""
    lib = get_lib()
    lp = np.ascontiguousarray(log_probs, dtype=np.float64)
    t, k = lp.shape
    out = np.zeros(t, dtype=np.int32)
    lp_p = lp.ctypes.data_as(_c_double_p)
    out_p = out.ctypes.data_as(_c_int32_p)
    if lm is None:
        space_id = charset.index(" ") if " " in charset else -1
        n = lib.ssp_ctc_beam_decode(lp_p, t, k, blank_id, beam_width,
                                    prune_logp, beta, space_id, out_p, t)
    else:
        n = lib.ssp_ctc_beam_decode_lm(
            _lm_handle(lm), lp_p, t, k, blank_id, beam_width, prune_logp,
            alpha, beta, charset.encode(), out_p, t)
    if n < 0:
        raise ValueError(f"the native beam search refused the LM (code {n})")
    return out[:n].tolist()


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """A FLAC file → (float64 samples, sample rate): (frames,) for mono,
    (frames, channels) otherwise. A stream cut short raises ``ValueError``
    ("<path>: truncated FLAC stream"), and so does any other stream the
    decoder refuses, with its code."""
    lib = get_lib()
    with open(path, "rb") as f:
        data = f.read()
    rate, channels = ctypes.c_int32(0), ctypes.c_int32(0)
    out = _c_float_p()
    n = lib.ssp_flac_decode(data, len(data), ctypes.byref(rate),
                            ctypes.byref(channels), ctypes.byref(out))
    if n == FLAC_TRUNCATED:
        raise ValueError(f"{path}: truncated FLAC stream")
    if n < 0:
        raise ValueError(f"{path}: the native FLAC decoder refused it: "
                         f"{FLAC_ERRORS.get(n, 'unknown error')} (code {n})")
    try:
        audio = np.ctypeslib.as_array(out, shape=(n * channels.value,)
                                      ).astype(np.float64)
    finally:
        lib.ssp_free(out)
    if channels.value > 1:
        audio = audio.reshape(n, channels.value)
    return audio, rate.value
