"""The bf16 attention forward of ``csrc/rel_attention_fwd_wmma.cu`` on the
CPU: its plain mirror (``rel_attention_plain(store_dtype=torch.bfloat16)``,
P' rounded to bf16 before ·V) against the JAX ``fused_rel_attention`` in
bf16 (the Pallas kernel in interpret mode), and a numpy replay of the
kernel's tiling (query tiles, key band, V chunks) at many shapes."""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from silent_speech_tpu.ops.pallas.rel_attention import fused_rel_attention
from silent_speech_tpu_torch.ops.rel_attention import (
    _probs, attention_drop_threshold, rel_attention, rel_attention_plain)

SEED = 31337
CSRC = Path(__file__).resolve().parents[1] / "silent_speech_tpu_torch" / "csrc"
QROWS = KROWS = 32   # query rows of a CTA, rows of a V chunk


def _inputs(b, h, t, dh, m, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, dh)).astype(np.float32) * scale
               for _ in range(3))
    e = rng.normal(size=(h, 2 * m - 1, dh)).astype(np.float32) * scale
    return q, k, v, e


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["nodrop", "drop"])
@pytest.mark.parametrize("b,h,t,dh,m", [
    (2, 2, 70, 16, 20),     # T not a multiple of 16, above the window
    (1, 3, 37, 32, 40),     # T < 2m − 1: the whole matrix in range
    (1, 2, 300, 16, 20),    # T above the band's columns (nb = 96)
])
def test_bf16_mirror_matches_the_pallas_kernel_in_bf16(rate, b, h, t, dh, m):
    xs = _inputs(b, h, t, dh, m, seed=t)
    thresh = attention_drop_threshold(rate)
    ref = fused_rel_attention(*(jnp.asarray(x, jnp.bfloat16) for x in xs),
                              jnp.asarray(SEED, jnp.int32), m, thresh)
    ref = np.asarray(ref.astype(jnp.float32))
    ours = rel_attention_plain(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in xs), m, None, SEED,
        thresh, store_dtype=torch.bfloat16)
    assert ours.dtype == torch.bfloat16 and ours.shape == (b, h, t, dh)
    # the same mask and rounding point of P'; JAX takes the softmax in
    # bf16 where the port takes it in f32
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_store_dtype_none_is_the_unrounded_plain_version(dtype, rate):
    q, k, v, e = (torch.from_numpy(x).to(dtype)
                  for x in _inputs(2, 2, 48, 16, 8, seed=2))
    thresh = attention_drop_threshold(rate)
    _, p = _probs(q, k, e, 8, 40, SEED, thresh)
    expected = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(dtype)
    for out in (rel_attention_plain(q, k, v, e, 8, 40, SEED, thresh),
                rel_attention_plain(q, k, v, e, 8, 40, SEED, thresh,
                                    store_dtype=None),
                rel_attention(q, k, v, e, 8, 40, SEED, thresh)):
        torch.testing.assert_close(out, expected, rtol=0, atol=0)
    rounded = rel_attention_plain(q, k, v, e, 8, 40, SEED, thresh,
                                  store_dtype=torch.bfloat16)
    torch.testing.assert_close(rounded, torch.einsum(
        "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), v.float()).to(dtype),
        rtol=0, atol=0)


def _round(x, n):
    return -(-x // n) * n


def band_cols(t, m):
    """``band_cols`` of ``csrc/wmma_band.cuh``."""
    return min(_round(t, 16), _round(QROWS + 2 * (m - 1) + 15, 16))


def test_band_cols_is_the_sources_formula():
    header = (CSRC / "wmma_band.cuh").read_text()
    body = re.search(r"inline int band_cols\(int T, int m\) \{\s*(.*?)\s*\}",
                     header, re.S).group(1)
    assert body == "return imin(round16(T), round16(QROWS + 2 * (m - 1) + " \
                   "15));"
    fwd = (CSRC / "rel_attention_fwd_wmma.cu").read_text()
    assert "const int kb = imax(0, q0 - (m - 1)) & ~15;" in fwd
    assert "const int ncp = round32(nb);" in fwd
    assert "ncp / KROWS," in fwd


@pytest.mark.parametrize("t,m", [
    (1, 1), (16, 1), (37, 8), (37, 100), (70, 20), (200, 100), (300, 20),
    (1024, 100), (2048, 100), (257, 129),
])
def test_kernel_tiling_covers_every_visible_key(t, m):
    """For each 32-query tile of the kernel's grid: every key that one of
    its queries sees lies in [kb, kb + nb); the V chunks cover that band;
    every other cell is invisible; and shared memory stays within the
    card's 227 KB at d_h = 128."""
    nb = band_cols(t, m)
    ncp = _round(nb, 32)
    pos = np.arange(t)
    for valid_len in sorted({0, 1, t // 3, t - 1, t}):
        side = pos < valid_len
        visible = ((np.abs(pos[None, :] - pos[:, None]) <= m - 1)
                   & (side[None, :] == side[:, None]))
        for q0 in range(0, t, QROWS):
            kb = max(0, q0 - (m - 1)) & ~15
            rows = visible[q0:q0 + QROWS]
            band = np.zeros(t, bool)
            band[kb:kb + nb] = True
            assert not (rows & ~band[None, :]).any(), (valid_len, q0)
            assert rows.any(1).all()          # each query sees itself
            # ncp / KROWS chunks of V rows from kb cover the band
            assert kb + (ncp // KROWS) * KROWS >= kb + nb
    # shared memory of fwd_smem at d_h = 128: Q tile, two chunks, S, R
    ldr = max(_round(2 * m - 1, 16), nb) + 4
    smem = 2 * (QROWS + 2 * KROWS) * 136 + 4 * (
        max(QROWS * (nb + 4), 8 * 256) + QROWS * (ldr + 1))
    assert smem <= 232448
    # P' (bf16, QROWS x (ncp + 8)) fits in R's region
    assert 2 * QROWS * (ncp + 8) <= 4 * QROWS * ldr
