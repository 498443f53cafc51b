"""The port's CTC beam decoder, its language models and its native search
against the JAX package: ``beam_ctc_decode`` (the native search and the
plain Python one) with no LM, an ARPA LM and a KenLM probing binary,
``load_lm`` and the LM scores, the order rule of the native context ring,
the native library's own build, and ``wer``. Decoded ids must be
identical."""

import math

import numpy as np
import pytest

from silent_speech_tpu import text as jax_text
from silent_speech_tpu.eval import decode as jax_decode
from silent_speech_tpu.eval.kenlm_binary import load_lm as jax_load_lm
from silent_speech_tpu_torch import text
from silent_speech_tpu_torch.eval import decode
from silent_speech_tpu_torch.eval.kenlm_binary import (KenLMBinary,
                                                       KenLMBinaryError,
                                                       load_lm)
from silent_speech_tpu_torch.utils import native

from test_kenlm_binary import ARPA, write_probing_binary

CHARS = text.CHARS
BLANK = len(CHARS)
SENTENCES = ("the cat the dog", "the dog cat", "cat the cat")
CONTEXTS = ([], ["<s>"], ["<s>", "the"], ["the", "cat"], ["cat"],
            ["dog", "the"], ["zebra"])
WORDS = ("the", "cat", "dog", "</s>", "zebra", "<unk>")


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm")
    arpa, binary = root / "lm.arpa", root / "lm.binary"
    arpa.write_text(ARPA)
    write_probing_binary(str(binary), ARPA)
    return {"arpa": str(arpa), "binary": str(binary)}


def _log_probs(sentence, seed):
    """Each character over two frames with a blank after it, plus noise,
    so that beams, repeats and word ends all compete."""
    rng = np.random.default_rng(seed)
    path = []
    for c in sentence:
        path += [CHARS.index(c)] * 2 + [BLANK]
    logits = rng.normal(size=(len(path), BLANK + 1)) * 1.5
    logits[np.arange(len(path)), path] += 4.0
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def _cases():
    return [(s, seed) for s in SENTENCES for seed in (0, 1)]


@pytest.mark.parametrize("lm_kind", [None, "arpa", "binary"])
@pytest.mark.parametrize("impl", ["native", "plain"])
def test_beam_matches_jax(lms, lm_kind, impl):
    ours_lm = None if lm_kind is None else load_lm(lms[lm_kind])
    ref_lm = None if lm_kind is None else jax_load_lm(lms[lm_kind])
    fn = decode.beam_ctc_decode if impl == "native" \
        else decode.beam_ctc_decode_plain
    for sentence, seed in _cases():
        lp = _log_probs(sentence, seed)
        ref = jax_decode.beam_ctc_decode(lp, CHARS, BLANK, beam_width=16,
                                         lm=ref_lm, alpha=1.5, beta=1.85)
        ours = fn(lp, CHARS, BLANK, beam_width=16, lm=ours_lm, alpha=1.5,
                  beta=1.85)
        assert ours == ref, (sentence, seed)


def test_the_lm_changes_the_decode(lms):
    # the cases above are not decided by the acoustics alone
    lm = load_lm(lms["arpa"])
    differ = [decode.beam_ctc_decode(lp, CHARS, BLANK, beam_width=16)
              != decode.beam_ctc_decode(lp, CHARS, BLANK, beam_width=16,
                                        lm=lm, alpha=3.0, beta=0.0)
              for lp in (_log_probs(s, seed) for s, seed in _cases())]
    assert any(differ)


@pytest.mark.parametrize("kind", ["arpa", "binary"])
def test_load_lm_matches_jax(lms, kind):
    ours, ref = load_lm(lms[kind]), jax_load_lm(lms[kind])
    assert type(ours).__name__ == type(ref).__name__
    assert ours.order == ref.order == 3
    for ctx in CONTEXTS:
        for word in WORDS:
            assert ours.score_word(ctx, word) == ref.score_word(ctx, word)
    assert ours.score_sentence(["the", "cat"]) == \
        ref.score_sentence(["the", "cat"])


@pytest.mark.parametrize("kind", ["arpa", "binary"])
def test_native_lm_scores_match_python(lms, kind):
    # the native ARPA reader keeps float32 scores (1e-9 relative measured
    # here), the KenLM binary stores float32: 1e-6 relative, as the JAX
    # package's own native tests hold them
    lm = load_lm(lms[kind])
    for ctx in CONTEXTS:
        for word in WORDS:
            assert native.lm_score_word(lm, ctx, word) == pytest.approx(
                lm.score_word(ctx, word), rel=1e-6)


def _arpa_of_order(path, order):
    words = [f"w{i}" for i in range(order)]
    lines = ["\\data\\"]
    lines += [f"ngram {n}={3 if n == 1 else 1}" for n in range(1, order + 1)]
    lines += ["", "\\1-grams:", "-0.5\t<s>\t-0.3", "-0.7\ta\t-0.3",
              "-2.0\t<unk>", ""]
    for n in range(2, order + 1):
        lines += [f"\\{n}-grams:", "-0.5\t" + " ".join(words[:n])
                  + ("\t-0.2" if n < order else ""), ""]
    lines.append("\\end\\")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_an_lm_past_the_native_ring_takes_the_plain_search(tmp_path):
    lm = decode.ArpaLM(_arpa_of_order(tmp_path / "big.arpa", 11))
    small = decode.ArpaLM(_arpa_of_order(tmp_path / "small.arpa", 10))
    assert not decode.native_beam_usable(lm)
    assert decode.native_beam_usable(small) and \
        decode.native_beam_usable(None)
    lp = _log_probs("a a", 3)
    with pytest.raises(ValueError, match="refused"):
        native.ctc_beam_decode(lp, CHARS, BLANK, 8, 1.85, lm=lm, alpha=1.5)
    ours = decode.beam_ctc_decode(lp, CHARS, BLANK, beam_width=8, lm=lm)
    ref = jax_decode.beam_ctc_decode(lp, CHARS, BLANK, beam_width=8,
                                     lm=jax_decode.ArpaLM(lm.path))
    assert ours == ref == decode.beam_ctc_decode_plain(
        lp, CHARS, BLANK, beam_width=8, lm=lm)


def test_the_native_library_is_built_from_the_port_sources():
    path = native.build()
    assert path == native.library_path() and path.is_file()
    assert path.parent == native.BUILD_DIR
    assert native.SOURCE_DIR.parent.name == "silent_speech_tpu_torch"
    for name in native.SOURCES:
        assert (native.SOURCE_DIR / name).is_file()
    assert native.build() == path   # built once, then reused


def test_a_failed_native_build_raises_with_the_compiler_message(
        tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="building the native beam"):
        native.build()
    assert not any(tmp_path.iterdir())   # no half-written library


def test_a_truncated_binary_raises(lms, tmp_path):
    data = open(lms["binary"], "rb").read()
    bad = tmp_path / "cut.binary"
    bad.write_bytes(data[: len(data) // 2])
    with pytest.raises(KenLMBinaryError):
        KenLMBinary(str(bad))
    with pytest.raises(FileNotFoundError):
        load_lm(str(tmp_path / "missing.binary"))


@pytest.mark.parametrize("refs,hyps", [
    ("the cat sat", "the cat sat"),
    (["the cat sat", "a dog"], ["the bat", "a dog ran"]),
    (["one two three four"], [""]),
    (["", "x y"], ["z", "x"]),
])
def test_wer_matches_jax(refs, hyps):
    assert text.wer(refs, hyps) == jax_text.wer(refs, hyps)
    assert text.edit_distance(list("kitten"), list("sitting")) == 3


def test_greedy_matches_jax():
    for sentence, seed in _cases():
        lp = _log_probs(sentence, seed)
        assert decode.greedy_ctc_decode(lp, BLANK) == \
            jax_decode.greedy_ctc_decode(lp, BLANK)
        assert math.isfinite(lp.sum())
