"""The float32 attention forward of ``csrc/rel_attention_fwd.cu`` on the
CPU: a numpy replay of its walk, with the tiling constants and index
formulas parsed from the source and from ``csrc/f32_band.cuh``.

The replay runs each CTA as the kernel does: R over the tile's slots in
256-column panels, scattered onto the band cells; S over the band's keys
in panels, the masks, the row max and sums; the dropout in place; P'.V
over 32-key chunks of V split between four warp pairs, and their partial
tiles summed in group order. It counts every output element written,
checks that each has exactly one owner, that each tile visits exactly the
slots and the keys its band covers (in several panels past m = 105), that
the products' shared-memory loads are free of bank conflicts, that a CTA
fits two an SM at m = 100, and that the replayed outputs match
``rel_attention_plain`` in float32."""

import math
import re
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.ops.dropout import hash_bits
from silent_speech_tpu_torch.ops import rel_attention_study as study
from silent_speech_tpu_torch.ops.rel_attention import (
    SMEM_PER_BLOCK_OPTIN, attention_drop_threshold, rel_attention_plain)

from torch_port_util import one_torch_thread

CSRC = Path(__file__).resolve().parents[1] / "silent_speech_tpu_torch" / "csrc"
SRC = "\n".join((CSRC / name).read_text()
                for name in ("f32_band.cuh", "rel_attention_fwd.cu"))
SEED = 24680


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


QA, NCOLS, KA, NBUF, NTHREADS = (_const(n) for n in ("QA", "NCOLS", "KA",
                                                      "NBUF", "NTHREADS"))
KV, NGROUPS, MIN_LDS = _const("KV"), _const("NGROUPS"), _const("MIN_LDS")
NWARPS, MAX_DH = NTHREADS // 32, _const("MAX_DH")
LDK, KG = KA + 4, KV // NGROUPS

# the source lines whose formulas the replay below repeats
FORMULAS = [
    "constexpr int NWARPS = NTHREADS / 32;", "constexpr int LDK = KA + 4;",
    "constexpr int KG = KV / NGROUPS;",
    "return imin(round16(T), round16(QA + 2 * (m - 1) + 15));",
    "return round32(band_cols(T, m)) + 8;",
    "return NBUF * (QA + NCOLS) * LDK + QA * score_ld(T, m) + 2 * NWARPS * QA;",
    "static constexpr int LDH = DH + 4;",
    "static constexpr int VW = NC % 4 == 0 ? 4 : (NC % 2 == 0 ? 2 : 1);",
    "const dim3 grid(ceil_div(T_len, QA), H, B);",
    # the band product
    "const int rows = ceil_div(ncols, 32) * 32;",
    "const bool live = 32 * warp < ncols;",
    "av[i] = *reinterpret_cast<const float4*>(a + (ly + 4 * i) * LDK + kk);",
    "bv[j] = *reinterpret_cast<const float4*>(b + (lx + 8 * j) * LDK + kk);",
    # R and S
    "const int kb = imax(0, q0 - (m - 1)) & ~15;",
    "const int ncp = round32(nb);", "const int ns = imin(nb, T - kb);",
    "const int r_lo = imax(0, m - QA - q0);",
    "const int r_hi = imin(W, T + m - 1 - q0);",
    "const int shift = r_lo + q0 - (m - 1) - kb;",
    "for (int p0 = 0; p0 < r_hi - r_lo; p0 += NCOLS) {",
    "imin(NCOLS, r_hi - r_lo - p0), r_hi, DH, sA, sB);",
    "const int col = c + shift + row;",
    "if (c < r_hi - r_lo && col >= 0 && col < nb)",
    "for (int p0 = 0; p0 < ncp; p0 += NCOLS) {", "if (p0 < ns)",
    "imin(NCOLS, ns - p0), T, DH, sA, sB);",
    "const int c = p0 + 32 * warp + lx + 8 * j;", "const int row = ly + 4 * i;",
    "if (c < ncp) {",
    "const float ex = x == -INFINITY ? 0.f : expf(x - mx[i]);",
    "hash_bits(q0 + row, kb + c, cell_seed) >=",
    "*s = keep ? ex : 0.f;",
    # P'.V
    "stage_async<DH>(sV, LDV, vh, DH, kb, KV, T, 0, DH);",
    "stage_async<DH>(sV + buf * KV * LDV, LDV, vh, DH, kb + c * KV, KV,",
    "ncp / KV,", "const int grp = warp >> 1;",
    "const int row0 = 16 * (warp & 1) + half;",
    "const bool live = q0 + 16 * (warp & 1) < T;",
    "const float* a = sS + row0 * lds + c * KV + KG * grp;",
    "const float* x = sV + buf * KV * LDV + KG * grp * LDV;",
    "av[i] = *reinterpret_cast<const float4*>(a + 2 * i * lds + kk);",
    "load_vec<C::VW>(x + (kk + s) * LDV + g * 16 * C::VW +",
    "const int t64 = threadIdx.x & 63;",
    "part[(((grp - 1) * 8 + i) * NC + n) * 64 + t64] = oacc[i][n];",
    "for (int g = 1; g < NGROUPS; ++g)",
    "const float mult = tot > 0.f ? (1.f / tot) * drop_scale : 0.f;",
    "store_rows(o + head, oacc, q0 + row0, 2, T, tx, 1.f);",
    "store_vec<C::VW>(out + (size_t)r * C::DH + g * 16 * C::VW + tx * C::VW,",
]


def test_the_replay_repeats_the_sources_formulas():
    missing = [line for line in FORMULAS if line not in SRC]
    assert not missing
    assert (QA, NCOLS, KA, NTHREADS, KV, NGROUPS) == (32, 256, 16, 256, 32, 4)
    assert NBUF >= 2 and KG % 4 == 0


@pytest.mark.parametrize("name,tag", [
    *(("rel_attention_fwd", t) for t in study.FWD_ABLATIONS),
    *(("rel_attention_bwd", t) for t in study.ABLATIONS)])
def test_the_studys_ablations_edit_the_sources_once(name, tag):
    # the card study builds each variant from these texts; an edit that no
    # longer applies would make it raise on the card
    ablations = (study.FWD_ABLATIONS if name == "rel_attention_fwd"
                 else study.ABLATIONS)
    edited = study.edited_texts(name, tag, ablations[tag])
    assert set(edited) == {f"{name}.cu", "f32_band.cuh"}
    assert any(edited[f] != (CSRC / f).read_text() for f in edited)


def _r16(x):
    return -(-x // 16) * 16


def _r32(x):
    return -(-x // 32) * 32


def _cdiv(a, b):
    return -(-a // b)


def band_cols(t, m):
    return min(_r16(t), _r16(QA + 2 * (m - 1) + 15))


def score_ld(t, m):
    return _r32(band_cols(t, m)) + 8


def fwd_bytes(t, m):
    return 4 * (NBUF * (QA + NCOLS) * LDK + QA * score_ld(t, m)
                + 2 * NWARPS * QA)


@pytest.mark.parametrize("t,m", [(200, 100), (256, 100), (2048, 100),
                                 (1, 1), (37, 8), (300, 130), (2048, 163),
                                 (4096, 681), (4096, 682)])
def test_the_score_buffer_takes_the_band_in_whole_v_chunks(t, m):
    # every P'.V chunk and every thread's cell column below ncp lies in a
    # row; the row stride keeps the cell tiles' rows 8 banks apart
    ncp = _r32(band_cols(t, m))
    assert ncp % KV == 0 and ncp <= score_ld(t, m)
    assert score_ld(t, m) >= MIN_LDS and score_ld(t, m) % 32 == 8
    assert fwd_bytes(t, m) == 4 * (NBUF * (QA + NCOLS) * LDK
                                   + QA * (ncp + 8) + 2 * NWARPS * QA)


@pytest.mark.parametrize("dh", range(16, MAX_DH + 1, 16))
def test_a_cta_fits_two_an_sm_at_m_100_and_the_parents_windows(dh):
    nc = dh // 16
    for t in (64, 200, 256, 1024, 2048):
        nbytes = fwd_bytes(t, 100)
        assert nbytes <= 113 * 1024
        assert 2 * (nbytes + 1024) <= 228 * 1024   # + 1 KB reserved a CTA
    # V's chunks reuse the E/K slices; the groups' partial tiles lie below
    # the reductions even at the narrowest band
    assert NBUF * KV * (dh + 4) <= NBUF * NCOLS * LDK
    assert (NGROUPS - 1) * 8 * nc * 64 <= (NBUF * (QA + NCOLS) * LDK
                                           + QA * MIN_LDS)
    # no narrower domain than the parent's one CTA of 256 (256 + 4m) bytes
    # at d_h = 96 (m <= 163) or 64 (2 dh + 64 + 4m) floats: every window
    # the parent took, at any T, fits the card
    for m in range(1, 700):
        parent = 4 * 64 * (2 * (dh + 1) + (2 * m - 1) + (64 + 2 * m - 1))
        if parent <= SMEM_PER_BLOCK_OPTIN:
            assert fwd_bytes(1 << 20, m) <= SMEM_PER_BLOCK_OPTIN, m
    assert fwd_bytes(1 << 20, 681) <= SMEM_PER_BLOCK_OPTIN
    assert fwd_bytes(1 << 20, 682) > SMEM_PER_BLOCK_OPTIN


def _cols(nc):
    """(tx, g, v) -> column of a thread's register tile in P'.V."""
    vw = 4 if nc % 4 == 0 else 2 if nc % 2 == 0 else 1
    return vw, {(tx, g, v): g * 16 * vw + tx * vw + v
                for tx in range(16) for g in range(nc // vw)
                for v in range(vw)}


def _pv_rows(warp, lane):       # rows row0 + 2i of a P'.V thread
    return [16 * (warp & 1) + (lane >> 4) + 2 * i for i in range(8)]


@pytest.mark.parametrize("nc", range(1, 9))
def test_each_output_of_a_tile_has_one_owner_in_each_group(nc):
    vw, cols = _cols(nc)
    for grp in range(NGROUPS):
        owners = sorted((r, c) for w in (2 * grp, 2 * grp + 1)
                        for lane in range(32) for r in _pv_rows(w, lane)
                        for (tx, g, v), c in cols.items()
                        if tx == (lane & 15))
        assert owners == sorted(product(range(QA), range(16 * nc)))
        # a warp holds 16 whole rows: what `live` tests
        for w in (2 * grp, 2 * grp + 1):
            rows = {r for lane in range(32) for r in _pv_rows(w, lane)}
            assert rows == set(range(16 * (w & 1), 16 * (w & 1) + 16))
    # the partial tiles: one slot per (group, i, n, thread of the group)
    slots = [(((g - 1) * 8 + i) * nc + n) * 64 + t
             for g in range(1, NGROUPS) for i in range(8) for n in range(nc)
             for t in range(64)]
    assert sorted(slots) == list(range(len(slots)))
    # the keys of a chunk: one group each
    keys = sorted(KG * g + kk + s for g in range(NGROUPS)
                  for kk in range(0, KG, 4) for s in range(4))
    assert keys == list(range(KV))


def _conflict_free(words_by_lane, width):
    """Whether one warp-wide shared access of `width` bytes a lane, lane l
    touching the 4-byte words words_by_lane[l], needs one pass a phase:
    the warp is served 128 bytes a phase (32, 16 or 8 lanes), and distinct
    words of one phase must lie in distinct banks."""
    per_phase = 128 // width
    for p in range(0, 32, per_phase):
        words = {w for lane in range(p, p + per_phase)
                 for w in words_by_lane[lane]}
        banks = [w % 32 for w in words]
        if len(banks) != len(set(banks)):
            return False
    return True


def _vec(word0, width):
    return [word0 + u for u in range(width // 4)]


@pytest.mark.parametrize("t,m", [(200, 100), (256, 100), (37, 8),
                                 (300, 130), (2048, 163)])
def test_the_band_products_and_cells_are_free_of_bank_conflicts(t, m):
    lds = score_ld(t, m)
    lanes = range(32)
    for warp, kk, i, j in product(range(NWARPS), range(0, KA, 4), range(8),
                                  range(4)):
        a = [_vec(((lane >> 3) + 4 * i) * LDK + kk, 16) for lane in lanes]
        b = [_vec((32 * warp + (lane & 7) + 8 * j) * LDK + kk, 16)
             for lane in lanes]
        assert _conflict_free(a, 16) and _conflict_free(b, 16)
        for p0 in range(0, _r32(band_cols(t, m)), NCOLS):
            cell = [[((lane >> 3) + 4 * i) * lds + p0 + 32 * warp
                     + (lane & 7) + 8 * j] for lane in lanes]
            assert _conflict_free(cell, 4)
        # the row max and sum partials: 4 rows a warp's store and read
        red = [[warp * QA + (lane >> 3) + 4 * i] for lane in lanes]
        assert _conflict_free(red, 4)


@pytest.mark.parametrize("nc", [1, 2, 3, 4, 5, 6, 7, 8])
def test_the_pv_loads_are_free_of_bank_conflicts(nc):
    vw, cols = _cols(nc)
    ldv = 16 * nc + 4
    for lds in {score_ld(t, m) for t, m in ((200, 100), (256, 100),
                                            (37, 8), (300, 130))}:
        for warp, c, kk, i in product(range(NWARPS), range(2),
                                      range(0, KG, 4), range(8)):
            grp = warp >> 1
            a = [_vec(_pv_rows(warp, lane)[i] * lds + c * KV + KG * grp + kk,
                      16) for lane in range(32)]
            assert _conflict_free(a, 16)
    for warp, kk, g in product(range(NWARPS), range(KG), range(nc // vw)):
        grp = warp >> 1
        x = [_vec((KG * grp + kk) * ldv + cols[(lane & 15, g, 0)], 4 * vw)
             for lane in range(32)]
        assert _conflict_free(x, 4 * vw)
        part = [[(((grp - 1) * 8 + 0) * nc + g) * 64 + (warp & 1) * 32 + lane]
                for lane in range(32)]
        assert _conflict_free(part, 4)


# ---------------------------------------------------------------- replay


def _keep(rows, cols, cell_seed, thresh):
    if not thresh:
        return np.ones((len(rows), len(cols)), bool)
    bits = hash_bits(torch.as_tensor(rows)[:, None],
                     torch.as_tensor(cols)[None, :], cell_seed)
    return (bits >= thresh).numpy()


def _take_rows(x, idx, n_rows):
    """x[idx] for 0 <= idx < n_rows, zero elsewhere (cp.async's fill)."""
    out = np.zeros((len(idx), x.shape[1]))
    ok = (idx >= 0) & (idx < n_rows)
    out[ok] = x[idx[ok]]
    return out


def _band(a, x, x0, ncols, n_rows):
    """band_product: the QA x NCOLS block, 0 in warps past ncols."""
    idx = x0 + np.arange(NCOLS)
    staged = np.arange(NCOLS) < _cdiv(ncols, 32) * 32
    acc = a @ _take_rows(x, np.where(staged, idx, -1), n_rows).T
    acc[:, (np.arange(NCOLS) // 32) * 32 >= ncols] = 0.0
    return acc


def replay(q, k, v, e, m, valid_len, seed, thresh, cells, visits):
    """The kernel's output (NaN where never written), how many times each
    element was written, and each tile's slots, S keys and P'.V keys in
    ``visits``."""
    b, h, t, dh = q.shape
    w = 2 * m - 1
    scale, drop_scale = 1 / math.sqrt(dh), 1 / (1 - thresh / 2 ** 32)
    b_off, h_off, h_tot = cells
    out = np.full(q.shape, np.nan)
    n_out = np.zeros(q.shape, int)
    nb = band_cols(t, m)
    ncp, lds = _r32(nb), score_ld(t, m)
    row = np.arange(QA)[:, None]
    c = np.arange(NCOLS)[None, :]
    for bi, hi in product(range(b), range(h)):
        cell_seed = (seed + (b_off + bi) * h_tot + h_off + hi) & 0xFFFFFFFF
        for q0 in range(0, _cdiv(t, QA) * QA, QA):
            kb = max(0, q0 - (m - 1)) & ~15
            ns = min(nb, t - kb)
            r_lo, r_hi = max(0, m - QA - q0), min(w, t + m - 1 - q0)
            shift = r_lo + q0 - (m - 1) - kb
            qt = _take_rows(q[bi, hi], q0 + np.arange(QA), t)
            s = np.full((QA, lds), np.nan)      # shared memory, unwritten
            slots, keys = set(), set()
            for p0 in range(0, r_hi - r_lo, NCOLS):
                ncols = min(NCOLS, r_hi - r_lo - p0)
                acc = _band(qt, e[hi], r_lo + p0, ncols, r_hi)
                slots |= set((r_lo + p0 + np.arange(ncols)).tolist())
                col = p0 + c + shift + row
                put = (p0 + c < r_hi - r_lo) & (col >= 0) & (col < nb)
                s[np.nonzero(put)[0], col[put]] = acc[put]
            for p0 in range(0, ncp, NCOLS):
                if p0 < ns:
                    ncols = min(NCOLS, ns - p0)
                    acc = _band(qt, k[bi, hi], kb + p0, ncols, t)
                    keys |= set((kb + p0 + np.arange(ncols)).tolist())
                cc = p0 + c
                inside = cc < ncp
                qi, kj = q0 + row, kb + cc
                rel = kj - qi
                visible = ((qi < t) & (kj < t) & (rel >= 1 - m)
                           & (rel <= m - 1)
                           & ((kj < valid_len) == (qi < valid_len)))
                cols = np.nonzero(inside[0])[0]
                old = s[:, p0 + cols]
                s[:, p0 + cols] = np.where(visible[:, cols],
                                           acc[:, cols] * scale + old,
                                           -np.inf)
            sc = s[:, :ncp]
            assert not np.isnan(sc).any()          # every cell written
            mx = sc.max(1, keepdims=True)
            ex = np.where(sc == -np.inf, 0.0,
                          np.exp(sc - np.where(np.isfinite(mx), mx, 0)))
            tot = ex.sum(1)
            keep = _keep(q0 + np.arange(QA), kb + np.arange(ncp), cell_seed,
                         thresh)
            pp = np.where(keep, ex, 0.0)
            # P'.V: chunk by chunk, each group its keys; dead warps keep 0
            part = np.zeros((NGROUPS, QA, dh))
            pv_keys = set()
            for ch in range(ncp // KV):
                vrows = kb + ch * KV + np.arange(KV)
                vc = _take_rows(v[bi, hi], vrows, t)
                pv_keys |= set(vrows[vrows < t].tolist())
                for g in range(NGROUPS):
                    sl = slice(ch * KV + KG * g, ch * KV + KG * g + KG)
                    part[g] += pp[:, sl] @ vc[KG * g:KG * g + KG]
            dead = q0 + 16 * (np.arange(QA) // 16) >= t
            part[:, dead] = 0.0
            acc_o = part[0]
            for g in range(1, NGROUPS):               # group order
                acc_o = acc_o + part[g]
            mult = np.where(tot > 0, drop_scale / np.where(tot > 0, tot, 1),
                            0.0)
            acc_o = acc_o * mult[:, None]
            live = q0 + np.arange(QA) < t
            out[bi, hi, q0 + np.arange(QA)[live]] = acc_o[live]
            n_out[bi, hi, q0 + np.arange(QA)[live]] += 1
            visits[(bi, hi, q0)] = (slots, keys, pv_keys, kb)
    return out, n_out


def _inputs(b, h, t, dh, m, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    e = rng.normal(size=(h, 2 * m - 1, dh)).astype(np.float32) * dh ** -0.5
    return q, k, v, e


CASES = {
    # (b, h, t, dh, m, valid_len, (b_offset, h_offset, h_total), rate)
    "training_t_and_m": (2, 2, 200, 16, 100, None, (0, 0, 2), 0.2),
    "valid_len_below_t": (2, 2, 72, 32, 16, 50, (0, 0, 2), 0.2),
    "t_below_window": (1, 2, 24, 16, 16, None, (0, 0, 2), 0.0),
    "ragged_offsets": (1, 2, 37, 48, 8, 20, (3, 4, 12), 0.2),
    "panels_past_m_105": (1, 1, 300, 16, 130, 250, (1, 0, 3), 0.2),
    "serving_bucket": (1, 1, 2048, 16, 100, 1500, (0, 0, 1), 0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_replayed_walk_has_one_owner_and_matches_plain(case):
    b, h, t, dh, m, valid_len, cells, rate = CASES[case]
    thresh = attention_drop_threshold(rate)
    xs = _inputs(b, h, t, dh, m, seed=t + m)
    visits = {}
    with one_torch_thread():
        ref = rel_attention_plain(*(torch.from_numpy(x) for x in xs), m,
                                  valid_len, SEED, thresh, b_offset=cells[0],
                                  h_offset=cells[1], h_total=cells[2])
        valid = t if valid_len is None else valid_len
        out, n_out = replay(*(x.astype(np.float64) for x in xs), m, valid,
                            SEED, thresh, cells, visits)
    assert (n_out == 1).all()
    assert np.isfinite(out).all()
    r = ref.numpy()
    np.testing.assert_allclose(out, r, rtol=0, atol=1e-5 * np.abs(r).max())

    # each tile: exactly the slots its rows reach from a key in [0, T);
    # its band's keys for S and P'.V, from kb (its first key rounded down
    # to 16) to at most the band's columns
    pos = np.arange(t)
    nb = band_cols(t, m)
    for (bi, hi, q0), (slots, keys, pv_keys, kb) in visits.items():
        qs = np.arange(q0, q0 + QA)
        near = np.abs(pos[None, :] - qs[:, None]) <= m - 1
        rows, cols = np.nonzero(near)
        reach = set((pos[cols] - qs[rows] + m - 1).tolist())
        assert slots == reach, q0
        band = set(pos[near[qs < t].any(0)].tolist()) if (qs < t).any() \
            else set()
        assert band <= keys <= set(range(kb, min(t, kb + nb))), q0
        assert band <= pv_keys <= set(range(kb, min(t, kb + _r32(nb)))), q0
        assert not band or kb >= min(band) - 15, q0
    if m > 105:
        assert nb > NCOLS and 2 * m - 1 > NCOLS   # two panels of each
