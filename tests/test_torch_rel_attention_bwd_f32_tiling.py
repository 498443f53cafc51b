"""The float32 attention backward of ``csrc/rel_attention_bwd.cu`` on the
CPU: a numpy replay of its four stages' walk, with the tiling constants and
index formulas parsed from the source and from ``csrc/f32_band.cuh``, where
stage A's band product, its staging and its constants live (shared with
the forward).

The replay runs each CTA as the kernels do: stage A's query tiles, its key
band and slot range, R scattered onto the band, the masks, the softmax, D
and the scratch (P', dS, dR) with its zeros; stage B's key tiles walking
their queries in slices, stage C's query tiles walking their keys and
slots, stage D's slot tiles over groups of batch rows and their sum in
group order. It counts every scratch cell and output row written, checks
that each has exactly one owner, that each tile visits exactly the rows
its band covers, and that the outputs match the staged mirror
(``rel_attention_bwd_staged_plain``) in float32. It also replays the
shared-memory addresses of the products' loads, which must be free of bank
conflicts, and the shared memory of each stage."""

import math
import re
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.ops.dropout import hash_bits
from silent_speech_tpu_torch.ops.rel_attention import (
    F32_BWD_COLS, attention_drop_threshold, f32_bwd_fits,
    rel_attention_bwd_staged_plain)

from torch_port_util import one_torch_thread

CSRC = Path(__file__).resolve().parents[1] / "silent_speech_tpu_torch" / "csrc"
SRC = "\n".join((CSRC / name).read_text()
                for name in ("f32_band.cuh", "rel_attention_bwd.cu"))
SEED = 97531
SMS = 132   # the H100's SMs, for the wrapper's dE groups


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


QA, NCOLS, KA, TILE, KC = (_const(n) for n in ("QA", "NCOLS", "KA", "TILE",
                                               "KC"))
NTHREADS, NBUF = _const("NTHREADS"), _const("NBUF")
LDK, LDS, LDT, LDC = KA + 4, NCOLS + 8, TILE + 4, KC + 4

# the source lines whose formulas the replay below repeats
FORMULAS = [
    "constexpr int LDK = KA + 4;", "constexpr int LDS = NCOLS + 8;",
    "constexpr int LDT = TILE + 4;", "constexpr int LDC = KC + 4;",
    "return imin(round16(T), round16(QA + 2 * (m - 1) + 15));",
    "return band_cols(T, m) > NCOLS || imin(2 * m - 1, T + QA - 1) > NCOLS;",
    "return sizeof(float) * (QA * LDS + NBUF * (QA + NCOLS) * LDK +",
    "return sizeof(float) * NBUF * KC * (LDT + dh + 4);",
    "return sizeof(float) * NBUF * (TILE * LDC + KC * (dh + 4));",
    # stage A
    "const int ly = lane >> 3;", "const int lx = lane & 7;",
    "const int kb = imax(0, q0 - (m - 1)) & ~15;",
    "const int ns = imin(nb, T - kb);",
    "const int r_lo = imax(0, m - QA - q0);",
    "const int r_hi = imin(W, T + m - 1 - q0);",
    "const int shift = r_lo + q0 - (m - 1) - kb;",
    "const int col = c + shift + row;",
    "if (c < r_hi - r_lo && col >= 0 && col < nb)",
    "const int rows = ceil_div(ncols, 32) * 32;",
    "const bool live = 32 * warp < ncols;",
    "const int c = 32 * warp + lx + 8 * j;", "const int row = ly + 4 * i;",
    "if (c >= nb || kj >= Tp) continue;",
    "if (kj < T && r >= 0 && r < W) dr[(row0 + qi) * Wp + r] = dsv;",
    "if (c < kb || c >= kb + nb) {",
    "if (r >= W || kj < 0 || kj >= T) dr[(row0 + qi) * Wp + r] = 0.f;",
    "const dim3 grid(ceil_div(round16(T), QA), H, B);",
    # stage B
    "const int k0 = (blockIdx.x >> 1) * TILE;",
    "const int q_lo = imax(0, k0 - (m - 1));",
    "const int q_hi = imin(T, k0 + TILE + m - 1);",
    "const bool live = k0 + 16 * warp < T;",
    "const dim3 grid(2 * ceil_div(T, TILE), H, B);",
    "store_rows((is_dv ? dv : dk) + head, acc, k0 + 8 * ty, 1, T, tx,",
    # stage C
    "const int row0 = 16 * warp + (ty & 1);",
    "const int k_lo = imax(0, q0 - (m - 1)) & ~3;",
    "const int k_hi = imin(T, q0 + TILE + m - 1);",
    "const int s_lo = imax(0, (m - 1) - (q0 + TILE - 1)) & ~3;",
    "const int s_hi = imin(W, T + m - 1 - q0);",
    "const bool live = q0 + 16 * warp < T;",
    "const dim3 grid(ceil_div(T, TILE), H, B);",
    "store_rows(dq + head, acc, q0 + row0, 2, T, tx, 1.f);",
    # stage D
    "const int q_lo = imax(0, (m - 1) - (s0 + TILE - 1));",
    "const int q_hi = imin(T, T + m - 1 - s0);",
    "const bool live = s0 + 16 * warp < 2 * m - 1;",
    "const int b_lo = g * rows_per_group;",
    "const int b_hi = imin(B, b_lo + rows_per_group);",
    "const dim3 grid(ceil_div(round16(W), TILE), H, groups);",
    "s0 + 8 * ty, 1,",
    "for (int g = 0; g < G; ++g)",
    # the columns of stages B-D
    "static constexpr int VW = NC % 4 == 0 ? 4 : (NC % 2 == 0 ? 2 : 1);",
    "g * 16 * C::VW + tx * C::VW",
]


def test_the_replay_repeats_the_sources_formulas():
    missing = [line for line in FORMULAS if line not in SRC]
    assert not missing
    assert (QA, NCOLS, KA, TILE, KC, NTHREADS) == (32, 256, 16, 128, 32, 256)
    assert NBUF >= 2
    assert F32_BWD_COLS == NCOLS


def _r16(x):
    return -(-x // 16) * 16


def _cdiv(a, b):
    return -(-a // b)


def band_cols(t, m):
    return min(_r16(t), _r16(QA + 2 * (m - 1) + 15))


def too_wide(t, m):
    return band_cols(t, m) > NCOLS or min(2 * m - 1, t + QA - 1) > NCOLS


@pytest.mark.parametrize("t,m", [(200, 100), (1024, 100), (300, 105),
                                 (300, 106), (225, 500), (226, 500),
                                 (256, 128), (257, 128), (1, 1), (37, 8)])
def test_f32_bwd_fits_is_the_sources_limit(t, m):
    assert f32_bwd_fits(t, m) == (not too_wide(t, m))


def _cols(nc):
    """(tx, g, v) -> column of a thread's register tile in stages B-D."""
    vw = 4 if nc % 4 == 0 else 2 if nc % 2 == 0 else 1
    return vw, {(tx, g, v): g * 16 * vw + tx * vw + v
                for tx in range(16) for g in range(nc // vw)
                for v in range(vw)}


@pytest.mark.parametrize("nc", range(1, 9))
def test_each_column_of_stages_b_to_d_has_one_owner(nc):
    vw, cols = _cols(nc)
    assert sorted(cols.values()) == list(range(16 * nc))
    assert all(c % vw == 0 for (tx, g, v), c in cols.items() if v == 0)


# threads of stages B-D: ty = tid >> 4, tx = tid & 15, warp = tid >> 5
def _rows_b(ty):            # stages B and D: 8 ty + i
    return [8 * ty + i for i in range(8)]


def _rows_c(ty):            # stage C: 16 warp + (ty & 1) + 2i
    return [16 * (ty >> 1) + (ty & 1) + 2 * i for i in range(8)]


@pytest.mark.parametrize("rows", [_rows_b, _rows_c], ids=["b_d", "c"])
def test_each_row_of_a_tile_has_one_owner_and_a_warp_holds_16(rows):
    owners = [r for ty in range(16) for r in rows(ty)]
    assert sorted(owners) == list(range(TILE))
    for w in range(NTHREADS // 32):   # the warp's rows: what `live` tests
        assert sorted(rows(2 * w) + rows(2 * w + 1)) == list(
            range(16 * w, 16 * w + 16))


def _conflict_free(words_by_lane, width):
    """Whether one warp-wide shared load of `width` bytes a lane, lane l
    reading the 4-byte words words_by_lane[l], needs one pass a phase: the
    warp is served 128 bytes a phase (32, 16 or 8 lanes), and distinct
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


def test_stage_a_loads_and_cells_are_free_of_bank_conflicts():
    for warp, kk, i, j in product(range(8), range(0, KA, 4), range(8),
                                  range(4)):
        lanes = range(32)
        a = [_vec(((lane >> 3) + 4 * i) * LDK + kk, 16) for lane in lanes]
        b = [_vec((32 * warp + (lane & 7) + 8 * j) * LDK + kk, 16)
             for lane in lanes]
        cell = [[((lane >> 3) + 4 * i) * LDS + 32 * warp + (lane & 7) + 8 * j]
                for lane in lanes]
        assert _conflict_free(a, 16) and _conflict_free(b, 16)
        assert _conflict_free(cell, 4)
    # the warp's 8 x 4 tiles cover the QA x NCOLS block once
    owners = sorted((ly + 4 * i, 32 * w + lx + 8 * j)
                    for w, ly, lx, i, j in product(range(8), range(4),
                                                   range(8), range(8),
                                                   range(4)))
    assert owners == sorted(product(range(QA), range(NCOLS)))


@pytest.mark.parametrize("nc", [1, 2, 3, 4, 6, 8])
def test_stage_b_to_d_loads_are_free_of_bank_conflicts(nc):
    vw, cols = _cols(nc)
    ldh = 16 * nc + 4
    for warp, kk in product(range(8), range(KC)):
        tys = [(32 * warp + lane) >> 4 for lane in range(32)]
        txs = [(32 * warp + lane) & 15 for lane in range(32)]
        # B and D: the transposed operand, two 128-bit loads a row
        for half in (0, 4):
            a = [_vec(kk * LDT + 8 * ty + half, 16) for ty in tys]
            assert _conflict_free(a, 16)
        # C: a 128-bit load a row of a TILE x KC slice
        if kk % 4 == 0:
            for i in range(8):
                a = [_vec(_rows_c(ty)[i] * LDC + kk, 16) for ty in tys]
                assert _conflict_free(a, 16)
        # the d_h operand, VW floats a load
        for g in range(nc // vw):
            x = [_vec(kk * ldh + cols[(tx, g, 0)], 4 * vw) for tx in txs]
            assert _conflict_free(x, 4 * vw)


@pytest.mark.parametrize("dh", [16, 96, 128])
def test_each_stage_fits_two_ctas_an_sm(dh):
    smem = {"A": 4 * (QA * LDS + NBUF * (QA + NCOLS) * LDK + 8 * QA + QA),
            "B": 4 * NBUF * KC * (LDT + dh + 4),
            "C": 4 * NBUF * (TILE * LDC + KC * (dh + 4)),
            "D": 4 * NBUF * KC * (LDT + dh + 4)}
    for stage, nbytes in smem.items():
        assert nbytes <= 110 * 1024, stage
        assert 2 * (nbytes + 1024) <= 228 * 1024, stage   # + 1 KB reserved


@pytest.mark.parametrize("b", [1, 2, 7, 64, 120, 130])
def test_de_groups_partition_the_batch_in_order(b):
    # ops/rel_attention._staged_bwd's f32 groups at 8 heads, 128-slot tiles
    for h, wp in ((8, 208), (2, 48)):
        groups = min(b, -(-8 * SMS // (h * -(-wp // TILE))))
        groups = -(-b // -(-b // groups))
        per = _cdiv(b, groups)
        rows = [list(range(g * per, min(b, g * per + per)))
                for g in range(groups)]
        assert all(rows) and sum(rows, []) == list(range(b))


# ---------------------------------------------------------------- replay


def _keep(rows, cols, cell_seed, thresh):
    if not thresh:
        return np.ones((len(rows), len(cols)), bool)
    bits = hash_bits(torch.as_tensor(rows)[:, None],
                     torch.as_tensor(cols)[None, :], cell_seed)
    return (bits >= thresh).numpy()


def _take_rows(x, idx, n_rows, width=None):
    """x[idx] for 0 <= idx < n_rows, zero elsewhere (cp.async's fill)."""
    out = np.zeros((len(idx), x.shape[1] if width is None else width))
    ok = (idx >= 0) & (idx < n_rows)
    out[ok] = x[idx[ok]]
    return out


def _take(mat, rows, n_rows, cols, n_cols):
    """mat[rows][:, cols] inside (n_rows, n_cols), zero elsewhere."""
    out = np.zeros((len(rows), len(cols)))
    r_ok = (rows >= 0) & (rows < n_rows)
    c_ok = cols < n_cols
    out[np.ix_(r_ok, c_ok)] = mat[np.ix_(rows[r_ok], cols[c_ok])]
    return out


def stage_a(q, k, v, e, dout, m, valid_len, seed, thresh, cells):
    """Stage A's scratch (P', dS, dR; NaN where never written) and how
    many times each cell was written."""
    b, h, t, dh = q.shape
    tp, w = _r16(t), 2 * m - 1
    wp = _r16(w)
    scale, drop_scale = 1 / math.sqrt(dh), 1 / (1 - thresh / 2 ** 32)
    b_off, h_off, h_tot = cells
    pp, ds = (np.full((b, h, tp, tp), np.nan) for _ in range(2))
    dr = np.full((b, h, tp, wp), np.nan)
    n_pp, n_dr = np.zeros(pp.shape, int), np.zeros(dr.shape, int)
    nb = band_cols(t, m)
    row = np.arange(QA)[:, None]
    c = np.arange(NCOLS)[None, :]

    def band(a, x, x0, ncols, n_rows):
        # a warp whose 32 columns lie at or past ncols keeps 0; the others
        # read x's rows x0 + c (the staged rows, zero at or past n_rows)
        idx = x0 + np.arange(NCOLS)
        staged = np.arange(NCOLS) < _cdiv(ncols, 32) * 32
        xs = _take_rows(x, np.where(staged, idx, -1), n_rows)
        acc = a @ xs.T
        acc[:, (np.arange(NCOLS) // 32) * 32 >= ncols] = 0.0
        return acc

    for bi, hi in product(range(b), range(h)):
        cell_seed = (seed + (b_off + bi) * h_tot + h_off + hi) & 0xFFFFFFFF
        for q0 in range(0, _cdiv(tp, QA) * QA, QA):
            kb = max(0, q0 - (m - 1)) & ~15
            ns = min(nb, t - kb)
            r_lo, r_hi = max(0, m - QA - q0), min(w, t + m - 1 - q0)
            qt = _take_rows(q[bi, hi], q0 + np.arange(QA), t)
            ot = _take_rows(dout[bi, hi], q0 + np.arange(QA), t)
            s = np.full((QA, NCOLS), np.nan)   # shared memory, unwritten
            acc = band(qt, e[hi], r_lo, r_hi - r_lo, r_hi)
            shift = r_lo + q0 - (m - 1) - kb
            col = c + shift + row
            put = (c < r_hi - r_lo) & (col >= 0) & (col < nb)
            s[np.nonzero(put)[0], col[put]] = acc[put]
            acc = band(qt, k[bi, hi], kb, ns, t)
            qi, kj = q0 + row, kb + c
            rel = kj - qi
            visible = ((qi < t) & (kj < t) & (rel >= 1 - m) & (rel <= m - 1)
                       & ((kj < valid_len) == (qi < valid_len)))
            s = np.where(visible, acc * scale + s, -np.inf)
            s[:, nb:] = np.nan                  # never read
            mx = s[:, :nb].max(1, keepdims=True)
            ex = np.where(s[:, :nb] == -np.inf, 0.0,
                          np.exp(s[:, :nb] - np.where(np.isfinite(mx), mx,
                                                      0)))
            tot = ex.sum(1, keepdims=True)
            inv = np.where(tot > 0, 1 / np.where(tot > 0, tot, 1), 0.0)
            p = np.zeros((QA, NCOLS))
            p[:, :nb] = ex * inv
            acc = band(ot, v[bi, hi], kb, ns, t)
            keep = _keep(q0 + np.arange(QA), kb + np.arange(NCOLS),
                         cell_seed, thresh)
            prod = np.where(keep, p * drop_scale * acc, 0.0)
            d = prod.sum(1, keepdims=True)
            dsv = prod - p * d
            wr = (qi < tp) & (c < nb) & (kj < tp)
            rr, cc = np.nonzero(wr)
            pp[bi, hi, q0 + rr, kb + cc] = np.where(keep, p * drop_scale,
                                                    0.0)[wr]
            ds[bi, hi, q0 + rr, kb + cc] = dsv[wr]
            n_pp[bi, hi, q0 + rr, kb + cc] += 1
            r = kj - qi + m - 1
            wr_r = (qi < tp) & (c < nb) & (kj < t) & (r >= 0) & (r < w)
            rr, cc = np.nonzero(wr_r)
            dr[bi, hi, q0 + rr, r[wr_r]] = dsv[wr_r]
            n_dr[bi, hi, q0 + rr, r[wr_r]] += 1
            # the zeros, row by row
            for i in range(QA):
                qrow = q0 + i
                if qrow >= tp:
                    break
                out = (np.arange(tp) < kb) | (np.arange(tp) >= kb + nb)
                pp[bi, hi, qrow, out] = 0.0
                ds[bi, hi, qrow, out] = 0.0
                n_pp[bi, hi, qrow, out] += 1
                rs = np.arange(wp)
                key = qrow + rs - (m - 1)
                zero = (rs >= w) | (key < 0) | (key >= t)
                dr[bi, hi, qrow, zero] = 0.0
                n_dr[bi, hi, qrow, zero] += 1
    return (pp, ds, dr), (n_pp, n_dr)


def stage_b(q, dout, pp, ds, m, visits):
    """dK and dV, each key row's writes counted; ``visits`` receives each
    key tile's query rows."""
    b, h, t, dh = q.shape
    tp = _r16(t)
    scale = 1 / math.sqrt(dh)
    outs = {"dk": np.full(q.shape, np.nan), "dv": np.full(q.shape, np.nan)}
    counts = np.zeros((2, b, h, t), int)
    for bi, hi, bx in product(range(b), range(h),
                              range(2 * _cdiv(t, TILE))):
        is_dv, k0 = bx & 1, (bx >> 1) * TILE
        mat = (pp if is_dv else ds)[bi, hi]
        x = (dout if is_dv else q)[bi, hi]
        q_lo, q_hi = max(0, k0 - (m - 1)), min(t, k0 + TILE + m - 1)
        acc = np.zeros((TILE, dh))
        seen = set()
        for sl in range(_cdiv(q_hi - q_lo, KC)):
            rows = q_lo + sl * KC + np.arange(KC)
            rows = np.where(rows < q_hi, rows, -1)   # zero-filled
            seen |= set(rows[rows >= 0].tolist())
            a = _take(mat, rows, tp, k0 + np.arange(TILE), tp)
            acc += a.T @ _take_rows(x, rows, q_hi)
        visits[(bi, hi, k0)] = seen
        keys = k0 + np.arange(TILE)
        acc[(k0 + 16 * (np.arange(TILE) // 16)) >= t] = 0.0   # dead warps
        live = keys < t
        name = "dv" if is_dv else "dk"
        outs[name][bi, hi, keys[live]] = acc[live] * (1.0 if is_dv
                                                      else scale)
        counts[is_dv, bi, hi, keys[live]] += 1
    return outs["dk"], outs["dv"], counts


def stage_c(k, e, ds, dr, m, visits):
    """dQ, each query row's writes counted; ``visits`` receives each query
    tile's key and slot columns."""
    b, h, t, dh = k.shape
    tp, w = _r16(t), 2 * m - 1
    wp = _r16(w)
    scale = 1 / math.sqrt(dh)
    dq = np.full(k.shape, np.nan)
    counts = np.zeros((b, h, t), int)
    # each row of the tile from its thread's (ty, i), as the store walks it
    order = np.array([r for ty in range(16) for r in _rows_c(ty)])
    for bi, hi, q0 in product(range(b), range(h), range(0, t, TILE)):
        rows = q0 + np.arange(TILE)
        acc = np.zeros((TILE, dh))
        k_lo, k_hi = max(0, q0 - (m - 1)) & ~3, min(t, q0 + TILE + m - 1)
        keys = set()
        for sl in range(_cdiv(k_hi - k_lo, KC)):
            cols = k_lo + sl * KC + np.arange(KC)
            keys |= set(cols[cols < tp].tolist())
            acc += (_take(ds[bi, hi], rows, tp, cols, tp)
                    @ _take_rows(k[bi, hi], cols, t))
        acc *= scale
        s_lo = max(0, (m - 1) - (q0 + TILE - 1)) & ~3
        s_hi = min(w, t + m - 1 - q0)
        slots = set()
        for sl in range(_cdiv(s_hi - s_lo, KC)):
            cols = s_lo + sl * KC + np.arange(KC)
            slots |= set(cols[cols < wp].tolist())
            acc += (_take(dr[bi, hi], rows, tp, cols, wp)
                    @ _take_rows(e[hi], cols, w))
        visits[(bi, hi, q0)] = (keys, slots)
        acc[(q0 + 16 * (np.arange(TILE) // 16)) >= t] = 0.0
        for r in order:
            if q0 + r < t:
                dq[bi, hi, q0 + r] = acc[r]
                counts[bi, hi, q0 + r] += 1
    return dq, counts


def stage_d(q, dr, m, groups):
    """dE from per-group partials summed in group order; each partial row
    and each dE element's writes counted."""
    b, h, t, dh = q.shape
    tp, w = _r16(t), 2 * m - 1
    wp = _r16(w)
    per = _cdiv(b, groups)
    part = np.full((groups, h, wp, dh), np.nan)
    n_part = np.zeros((groups, h, wp), int)
    for s0, hi, g in product(range(0, wp, TILE), range(h), range(groups)):
        b_lo, b_hi = g * per, min(b, g * per + per)
        q_lo = max(0, (m - 1) - (s0 + TILE - 1))
        q_hi = min(t, t + m - 1 - s0)
        nq = _cdiv(q_hi - q_lo, KC) if q_hi > q_lo else 0
        acc = np.zeros((TILE, dh))
        for c in range((b_hi - b_lo) * nq if b_hi > b_lo else 0):
            bi = b_lo + c // nq
            rows = q_lo + (c % nq) * KC + np.arange(KC)
            rows = np.where(rows < q_hi, rows, -1)
            acc += (_take(dr[bi, hi], rows, tp, s0 + np.arange(TILE), wp).T
                    @ _take_rows(q[bi, hi], rows, q_hi))
        acc[(s0 + 16 * (np.arange(TILE) // 16)) >= w] = 0.0
        slots = s0 + np.arange(TILE)
        live = slots < wp
        part[g, hi, slots[live]] = acc[live]
        n_part[g, hi, slots[live]] += 1
    de = np.zeros((h, w, dh))
    for g in range(groups):              # bwd_f32_de_reduce's order
        de += part[g, :, :w]
    return de, n_part


def _inputs(b, h, t, dh, m, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, t, dh)).astype(np.float32) * 0.3
                  for _ in range(4))
    e = rng.normal(size=(h, 2 * m - 1, dh)).astype(np.float32) * 0.3
    return q, k, v, e, g


CASES = {
    # (b, h, t, dh, m, valid_len, (b_offset, h_offset, h_total), rate)
    "training_t_and_m": (2, 2, 200, 16, 100, None, (0, 0, 2), 0.2),
    "valid_len_below_t": (2, 2, 72, 16, 16, 50, (0, 0, 2), 0.2),
    "t_below_window": (1, 2, 24, 16, 16, None, (0, 0, 2), 0.2),
    "ragged_offsets": (1, 2, 37, 32, 8, 20, (3, 4, 12), 0.2),
    "key_tiles_past_the_band": (1, 1, 300, 16, 20, 250, (0, 0, 1), 0.2),
    "dh48_t129_offsets": (2, 3, 129, 48, 40, None, (1, 2, 8), 0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_replayed_walk_has_one_owner_and_matches_the_mirror(case):
    b, h, t, dh, m, valid_len, cells, rate = CASES[case]
    thresh = attention_drop_threshold(rate)
    xs = _inputs(b, h, t, dh, m, seed=t)
    qn, kn, vn, en, gn = (x.astype(np.float64) for x in xs)
    with one_torch_thread():
        (ref, scratch) = rel_attention_bwd_staged_plain(
            *(torch.from_numpy(x) for x in xs), m, valid_len, SEED, thresh,
            return_scratch=True, b_offset=cells[0], h_offset=cells[1],
            h_total=cells[2])
        valid = t if valid_len is None else valid_len
        (pp, ds, dr), (n_pp, n_dr) = stage_a(qn, kn, vn, en, gn, m, valid,
                                             SEED, thresh, cells)
    tp, w = _r16(t), 2 * m - 1
    # every scratch cell written once, finite, zero in the padding, and
    # the mirror's P', dS and dR inside
    assert (n_pp == 1).all() and (n_dr == 1).all()
    for name, ours, r, cols in (("P'", pp, scratch[0], t),
                                ("dS", ds, scratch[1], t),
                                ("dR", dr, scratch[2], w)):
        assert np.isfinite(ours).all(), name
        r = r.numpy()
        np.testing.assert_allclose(ours[:, :, :t, :cols], r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
        assert not ours[:, :, t:].any() and not ours[:, :, :, cols:].any()

    visits_b, visits_c = {}, {}
    dk, dv, n_kv = stage_b(qn, gn, pp, ds, m, visits_b)
    dq, n_q = stage_c(kn, en, ds, dr, m, visits_c)
    groups = min(b, -(-8 * SMS // (h * -(-_r16(w) // TILE))))
    groups = -(-b // -(-b // groups))
    de, n_part = stage_d(qn, dr, m, groups)
    de_one, _ = stage_d(qn, dr, m, 1)
    assert (n_kv == 1).all() and (n_q == 1).all() and (n_part == 1).all()

    # stage B: a key tile visits exactly the queries whose band covers one
    # of its keys; stage C: a query tile's keys and slots cover its band
    # and reach at most 3 columns before it (aligned down to 4)
    pos = np.arange(t)
    for (bi, hi, k0), seen in visits_b.items():
        keys = pos[k0:k0 + TILE]
        band = pos[(np.abs(pos[:, None] - keys[None, :]) <= m - 1).any(1)]
        assert seen == set(band.tolist()), k0
    for (bi, hi, q0), (keys, slots) in visits_c.items():
        qs = pos[q0:q0 + TILE]
        near = np.abs(pos[None, :] - qs[:, None]) <= m - 1
        band = set(pos[near.any(0)].tolist())
        assert band <= keys and min(keys) >= min(band) - 3, q0
        reach = {int(kk - qq + m - 1) for qq in qs for kk in pos
                 if abs(kk - qq) <= m - 1}
        assert reach <= slots and min(slots) >= min(reach) - 3, q0

    for name, ours, r in zip(("dq", "dk", "dv", "de"), (dq, dk, dv, de),
                             ref):
        r = r.numpy()
        assert np.isfinite(ours).all(), name
        np.testing.assert_allclose(ours, r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
    # the groups change dE's sum order only
    np.testing.assert_allclose(de, de_one, rtol=0,
                               atol=1e-9 * np.abs(de).max())
