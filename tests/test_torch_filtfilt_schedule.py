"""A numpy replay of the filter-chain kernel's schedule
(``silent_speech_tpu_torch/csrc/filtfilt.cu``) against the plain version.

The kernel gives a CTA 32 columns, one lane each: the chain's warp steps
every lane in lockstep through a ring of ``RING`` tiles of ``TILE`` steps
in shared memory (a slot is [step][lane]); ``MOVERS`` producer warps fill
each tile ahead of it, each lane from its own column in its own direction
(x or the (B, T_pad + 2P, C) scratch, or the table of odd extensions);
``MOVERS`` drain warps copy each finished tile to the rows it belongs to;
the last warp writes the zeros of ``out`` past each length. Each mover
warp moves its share of a tile's steps, W floats a lane: with C % 4 == 0,
4 adjacent channels of one utterance at every 4th step (a warp
instruction, 4 steps of 32 columns), else a lane's own column a step at a
time. This replay runs the same schedule with the kernel's constants
(parsed from the source) and its row formulas: the ring slots and their
hand-offs (full, done, empty, the producer's lag of ``LAG`` tiles, the
named barrier between passes), the rows each lane reads and writes at
each step, the reverse passes' per-lane starts and the first pass's
reads of x and the last pass's writes to ``out``. Global
memory starts poisoned with NaN, reads are bounds-checked, and the producer
reads and writes a tile at issue time, the earliest the hardware could, so
that an early read or a slot reused too soon shows in the output. The
arithmetic is float32 numpy, one rounding an operation as the kernel's
``__fmul_rn``/``__fadd_rn``/``__fsub_rn``, so the result must equal
``filtfilt_chain_plain`` bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.dsp.device_pipeline import filter_coeffs
from silent_speech_tpu_torch.ops.filtfilt import (_table, chain_padlen,
                                                  filtfilt_chain_plain)

SOURCE = (Path(__file__).resolve().parents[1] / "silent_speech_tpu_torch"
          / "csrc" / "filtfilt.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


LANES, TILE, RING, LAG, MOVERS = (
    _constant(n) for n in ("LANES", "TILE", "RING", "LAG", "MOVERS"))
MAX_PAD = 3 * (_constant("MAX_DELAYS") + 1)
F32 = np.float32


class Memory:
    """A global buffer whose reads are bounds-checked."""

    def __init__(self, array):
        self.a = array.reshape(-1)

    def read(self, i):
        assert 0 <= i < self.a.size, f"read at {i} of {self.a.size}"
        return self.a[i]

    def write(self, i, v):
        assert 0 <= i < self.a.size, f"write at {i} of {self.a.size}"
        self.a[i] = v


def pass_steps(L, p, reverse):
    return L + p if reverse else L + 2 * p


def tiles_of(steps):
    return -(-steps // TILE)


class Block:
    """One CTA: its lanes' columns, its ring, and the chain's, the
    producer's and the drain's states."""

    def __init__(self, blk, x, lengths, scratch, out, nd, coef, t_pad, c_,
                 P):
        self.x, self.scratch, self.out = x, scratch, out
        self.nd, self.coef, self.t_pad, self.C, self.P = nd, coef, t_pad, c_, P
        self.rows = t_pad + 2 * P
        cols = len(lengths) * c_
        col = blk * LANES + np.arange(LANES)
        self.active = col < cols
        self.u = np.where(self.active, col // c_, 0)
        self.c = np.where(self.active, col % c_, 0)
        self.L = np.where(self.active, lengths[self.u], 0)
        self.l_max = int(self.L.max())
        # the movers' units: lane l of mover mv moves columns W*m .. W*m +
        # W - 1 at the tile's steps s, s + W, ... (PER of them)
        self.W = 4 if c_ % 4 == 0 else 1
        self.per = TILE // (self.W * MOVERS)
        self.units = [(lane % (LANES // self.W),
                       lane // (LANES // self.W) + mv * (TILE // MOVERS))
                      for mv in range(MOVERS) for lane in range(LANES)]
        for m, _ in self.units:   # a unit's columns share an utterance
            first = self.W * m
            assert len(set(self.u[first: first + self.W])) == 1
            assert len(set(self.active[first: first + self.W])) == 1
        self.ring = np.full((RING, TILE * LANES), np.nan, F32)
        self.ext = np.full((2 * MAX_PAD, LANES), np.nan, F32)
        # the tiles in order: (filter, reverse, k)
        self.tiles = [(f, r, k) for f in range(len(nd)) for r in (0, 1)
                      for k in range(tiles_of(pass_steps(
                          self.l_max, 3 * (nd[f] + 1), r)))]
        self.full = [False] * len(self.tiles)   # handed to the chain
        self.done = [False] * len(self.tiles)   # the chain finished it
        self.drained = [False] * len(self.tiles)
        self.issued = 0
        self.chained = 0
        self.drained_n = 0
        self.z = None

    # warp 1 ----------------------------------------------------------------
    def _x_col(self, lane, t):          # x row t of lane's column
        return (self.u[lane] * self.t_pad + t) * self.C + self.c[lane]

    def _s_col(self, lane, r):          # scratch row r of lane's column
        return (self.u[lane] * self.rows + r) * self.C + self.c[lane]

    def _pass_start(self, f, reverse):
        """The producer's set-up of a pass (the extension table)."""
        p = 3 * (self.nd[f] + 1)
        if reverse:
            return
        for lane in np.flatnonzero(self.active):
            L = self.L[lane]
            if f == 0:
                def read(t):
                    return self.x.read(self._x_col(lane, t))
            else:
                def read(t):
                    return self.scratch.read(self._s_col(lane, self.P + t))
            x0, xl = read(0), read(L - 1)
            for k in range(p):
                self.ext[k, lane] = F32(2) * x0 - read(p - k)
                self.ext[p + k, lane] = F32(2) * xl - read(L - 2 - k)

    def _source(self, f, reverse, lane, q):
        """Where step q of a lane's pass reads: ('mem', memory, index),
        ('ext', row) or None."""
        p = 3 * (self.nd[f] + 1)
        L, act = self.L[lane], self.active[lane]
        if not reverse:
            lo, hi = p, (p + L if act else p)
            ext_end = L + 2 * p if act else 2 * p
            if lo <= q < hi:
                if f == 0:
                    return ("mem", self.x, self._x_col(lane, q - p))
                return ("mem", self.scratch,
                        self._s_col(lane, self.P + q - p))
            if q < lo:
                return ("ext", q)
            if q < ext_end:
                return ("ext", q - L)
            return None
        hi = L + p if act else 0
        if 0 <= q < hi:
            return ("mem", self.scratch,
                    self._s_col(lane, self.P + L + p - 1 - q))
        return None

    def can_issue(self):
        g = self.issued
        if g == len(self.tiles):
            return False
        if g >= RING and not self.drained[g - RING]:
            return False
        f, r, k = self.tiles[g]
        if k == 0 and g > 0:   # the named barrier: the last pass drained
            return all(self.drained[:g])
        return True

    def issue(self):
        g = self.issued
        f, r, k = self.tiles[g]
        if k == 0:
            self._pass_start(f, r)
        slot = g % RING
        W = self.W
        for m, s in self.units:
            lane = W * m       # the unit's first column; its source's
            for i in range(self.per):
                v = s + W * i
                src = self._source(f, r, lane, k * TILE + v)
                if src is None:
                    continue
                for j in range(W):  # W adjacent floats of one row
                    if src[0] == "mem":
                        assert src[2] + j == self._source(
                            f, r, lane + j, k * TILE + v)[2]
                        self.ring[slot, v * LANES + lane + j] = \
                            src[1].read(src[2] + j)
                    else:
                        self.ring[slot, v * LANES + lane + j] = self.ext[
                            src[1], lane + j]
        self.issued += 1
        self._hand_over(g, f, r, k)

    def _hand_over(self, g, f, r, k):
        # the hand-offs: tile g - LAG once tile g is committed; the pass's
        # last LAG tiles at its end
        n_pass = sum(1 for t in self.tiles if t[:2] == (f, r))
        first = g - k
        if k >= LAG:
            self.full[g - LAG] = True
        if k == n_pass - 1:
            for h in range(first + max(n_pass - LAG, 0), g + 1):
                self.full[h] = True

    # warp 0 ----------------------------------------------------------------
    def can_chain(self):
        return (self.chained < len(self.tiles) and self.full[self.chained])

    def chain(self):
        g = self.chained
        f, r, k = self.tiles[g]
        n = self.nd[f]
        b = self.coef[f, : n + 1]
        a = self.coef[f, 4: 5 + n]
        zi = self.coef[f, 8: 8 + n]
        t = self.ring[g % RING]
        if k == 0:
            self.z = [zi[j] * t[:LANES] for j in range(n)]
        z = self.z
        for v in range(TILE):
            at = slice(v * LANES, (v + 1) * LANES)
            e = t[at].copy()
            y = b[0] * e + z[0]
            z = [((z[j + 1] if j + 1 < n else F32(0)) + b[j + 1] * e)
                 - a[j + 1] * y for j in range(n)]
            t[at] = y
        self.z = z
        self.done[g] = True
        self.chained += 1

    # warp 2 ----------------------------------------------------------------
    def _dest(self, f, reverse, lane, q):
        p = 3 * (self.nd[f] + 1)
        L, act = self.L[lane], self.active[lane]
        if not reverse:
            if act and q < L + 2 * p:
                return self.scratch, self._s_col(lane, self.P - p + q)
            return None
        if not (act and p <= q < L + p):
            return None
        if f + 1 == len(self.nd):
            return self.out, self._x_col(lane, L + p - 1 - q)
        return self.scratch, self._s_col(lane, self.P + L + p - 1 - q)

    def can_drain(self):
        return (self.drained_n < len(self.tiles)
                and self.done[self.drained_n])

    def drain(self):
        g = self.drained_n
        f, r, k = self.tiles[g]
        t = self.ring[g % RING]
        W = self.W
        for m, s in self.units:
            lane = W * m
            for i in range(self.per):
                v = s + W * i
                dst = self._dest(f, r, lane, k * TILE + v)
                if dst is None:
                    continue
                for j in range(W):
                    assert dst[1] + j == self._dest(f, r, lane + j,
                                                    k * TILE + v)[1]
                    dst[0].write(dst[1] + j, t[v * LANES + lane + j])
        self.drained[g] = True
        self.drained_n += 1

    # warp 3 ----------------------------------------------------------------
    def zeros(self):
        for lane in np.flatnonzero(self.active):
            for t in range(self.L[lane], self.t_pad):
                self.out.write(self._x_col(lane, t), F32(0))


def replay(x, lengths, coeffs, order=("issue", "chain", "drain")):
    """The kernel's output for x (B, T_pad, C) float32 and lengths (B,),
    its warps' steps taken in the priority ``order`` whenever allowed."""
    nd, coef = _table(coeffs)
    b_, t_pad, c_ = x.shape
    P = chain_padlen(coeffs)
    xm = Memory(x.copy())
    scratch = Memory(np.full((b_, t_pad + 2 * P, c_), np.nan, F32))
    out = np.full(x.shape, np.nan, F32)
    om = Memory(out)
    blocks = -(-(b_ * c_) // LANES)
    with np.errstate(all="ignore"):   # lanes past their end: garbage
        for blk in range(blocks):
            cta = Block(blk, xm, np.asarray(lengths), scratch, om, nd, coef,
                        t_pad, c_, P)
            cta.zeros()
            steps = {"issue": (cta.can_issue, cta.issue),
                     "chain": (cta.can_chain, cta.chain),
                     "drain": (cta.can_drain, cta.drain)}
            while cta.drained_n < len(cta.tiles):
                for name in order:
                    can, act = steps[name]
                    if can():
                        act()
                        break
                else:
                    raise AssertionError("the schedule deadlocks")
    return out


def _emg(lengths, t_pad, c_, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), t_pad, c_), F32)
    for u, n in enumerate(lengths):
        x[u, :n] = rng.normal(size=(n, c_)) * 100
    return x


def _plain(x, lengths, coeffs):
    return filtfilt_chain_plain(torch.from_numpy(x),
                                torch.tensor(lengths), coeffs).numpy()


CHAIN = filter_coeffs()                      # 7 notches + the high-pass
P_HP = chain_padlen(CHAIN)                   # 12


@pytest.mark.parametrize("order", [("issue", "chain", "drain"),
                                   ("drain", "chain", "issue")],
                         ids=["producer_ahead", "drain_first"])
def test_the_schedule_gives_the_plain_chain_bit_for_bit(order):
    # ragged lengths: the high-pass's padlen + 1, T_pad itself, one tile
    # and a step, several tiles and odd remainders; C = 8 (the EMG's), 6
    # utterances = 48 columns, so the second CTA has 16 idle lanes; a pass
    # spans more tiles than the ring holds, so slots are reused within it
    t_pad = RING * TILE + 3 * TILE // 2
    lengths = [P_HP + 1, t_pad, TILE + 1, 200, 3 * TILE, 97]
    x = _emg(lengths, t_pad, 8, seed=0)
    got = replay(x, lengths, CHAIN, order)
    want = _plain(x, lengths, CHAIN)
    assert np.array_equal(got, want)
    assert not np.isnan(got).any()


@pytest.mark.parametrize("c_", [4, 12, 16, 32])
def test_16_byte_moves_at_other_channel_counts(c_):
    # 4 adjacent channels a lane at C = 4, 16, 32 (8, 2 and 1 utterances a
    # CTA) and C = 12 (utterances straddle CTAs); a short chain of a notch
    # and the high-pass
    coeffs = (CHAIN[0], CHAIN[-1])
    t_pad = 150
    lengths = [P_HP + 1, t_pad, 77, 140, 99, 150, 13 + TILE, 120, 100]
    x = _emg(lengths, t_pad, c_, seed=c_)
    assert np.array_equal(replay(x, lengths, coeffs),
                          _plain(x, lengths, coeffs))


@pytest.mark.parametrize("taps", [2, 3, 4])
def test_one_filter_of_each_width_and_columns_across_ctas(taps):
    # a chain of one filter (the first pass reads x and the last writes
    # out), C = 3 so that utterances straddle CTAs, T_pad under a tile so a
    # pass is one tile, fewer than the producer's lag
    from scipy.signal import butter

    b, a = butter(taps - 1, 0.1, btype="highpass")
    coeffs = ((b, a),)
    p = chain_padlen(coeffs)
    t_pad = 40
    lengths = [p + 1, t_pad, 27, 39, p + 2, 31, 40, 33, 25, 38, 36]
    x = _emg(lengths, t_pad, 3, seed=taps)
    got = replay(x, lengths, coeffs)
    assert np.array_equal(got, _plain(x, lengths, coeffs))


def test_the_rows_each_lane_reads_and_writes():
    # the per-lane row formulas of one CTA of the cleaning chain: the first
    # forward pass reads x rows 0..L-1, each reverse pass starts at the
    # lane's own last row of y and walks down, the drain writes y to rows
    # P - p .. P + L + p - 1 and the last reverse pass out's rows L-1..0
    lengths = [P_HP + 1, 100, 57, 100]
    x = _emg(lengths, 100, 8, seed=3)
    nd, coef = _table(CHAIN)
    P = P_HP
    cta = Block(0, Memory(x), np.asarray(lengths),
                Memory(np.zeros((4, 100 + 2 * P, 8), F32)),
                Memory(np.zeros_like(x)), nd, coef, 100, 8, P)
    rows = 100 + 2 * P
    for lane in (0, 9, 17, 31):
        u, c, L = lane // 8, lane % 8, lengths[lane // 8]
        p = 3 * (nd[0] + 1)
        fwd = [cta._source(0, 0, lane, q) for q in range(L + 2 * p)]
        assert [s[0] for s in fwd] == ["ext"] * p + ["mem"] * L + \
            ["ext"] * p
        assert [s[2] for s in fwd[p: p + L]] == [
            (u * 100 + t) * 8 + c for t in range(L)]
        assert cta._source(0, 0, lane, L + 2 * p) is None
        rev = [cta._source(0, 1, lane, q)[2] for q in range(L + p)]
        assert rev == [(u * rows + P + L + p - 1 - q) * 8 + c
                       for q in range(L + p)]
        assert cta._source(0, 1, lane, L + p) is None
        last = len(nd) - 1
        p_last = 3 * (nd[last] + 1)
        outs = [cta._dest(last, 1, lane, q) for q in range(L + p_last + 1)]
        assert all(o is None for o in outs[:p_last] + outs[-1:])
        assert [o[1] for o in outs[p_last: L + p_last]] == [
            (u * 100 + L - 1 - t) * 8 + c for t in range(L)]
        ys = [cta._dest(0, 0, lane, q)[1] for q in range(L + 2 * p)]
        assert ys == [(u * rows + P - p + q) * 8 + c
                      for q in range(L + 2 * p)]
