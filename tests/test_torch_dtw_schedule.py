"""The schedule of the DTW kernel ``csrc/dtw.cu``, replayed in numpy on the
CPU: where each cost comes from and when its load is issued, when each
choice word is built and stored, which warps join the per-diagonal
barrier, and the backtrace's walk over the plain version's choices packed
in the kernel's word layout. The kernel's constants are read from its
source."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.ops.dtw import (
    MAX_ROWS, dtw_align_batch_plain, dtw_choices_plain)

SOURCE = (Path(__file__).resolve().parents[1] / "silent_speech_tpu_torch"
          / "csrc" / "dtw.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


NTHREADS = _const("NTHREADS")
ROWS_PER_THREAD = _const("MAX_ROWS_PER_THREAD")
RING = _const("RING")


def rows_per_thread(t1):
    """``launch``'s choice of the template parameter R."""
    return 1 if t1 <= NTHREADS else 2 if t1 <= 2 * NTHREADS else 4


def window(r, itemsize):
    """``dtw_kernel``'s LW: diagonals a cost window covers."""
    return 16 // itemsize if r == 1 else 8 // r


def test_the_constants_are_the_sources():
    assert MAX_ROWS == NTHREADS * ROWS_PER_THREAD == 4096
    assert "constexpr int LW = R == 1 ? 16 / (int)sizeof(T) : 8 / R;" in SOURCE
    for r in (1, 2, 4):
        for itemsize in (2, 4):
            assert 16 % window(r, itemsize) == 0  # windows tile a block


# --- the cost loads -------------------------------------------------------

def window_schedule(i, n1, n2, lw):
    """Replay row i of ``dtw_kernel``'s cost windows: window start diagonal
    → (diagonal its loads were issued, -1 before the loop; columns
    loaded)."""
    last = n1 + n2 - 2
    issued = {}

    def issue(kw, at):
        cols = ([kw - i + m for m in range(lw) if 1 <= kw - i + m < n2]
                if 1 <= i < n1 else [])
        issued[kw] = (at, cols)

    issue(0, -1)
    for k0 in range(0, last + 1, 16):
        for q in range(16):
            if q % lw == 0:
                issue(k0 + q + lw, k0 + q)
    return issued


SHAPES = [  # (T1, T2, n1, n2)
    (1, 1024, 1, 1), (2, 2, 2, 2), (1024, 1024, 730, 700),
    (1024, 1024, 1024, 1024), (1024, 1001, 1024, 1001),
    (1025, 1024, 1025, 1000), (2048, 1536, 2048, 1536),
    (4096, 1024, 4096, 1024), (4096, 1001, 4000, 999), (1024, 7, 600, 7),
    (1024, 7, 3, 5), (1024, 1024, 282, 1), (1024, 1024, 1, 282),
    (1024, 1024, 500, 9),
]


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("t1,t2,n1,n2", SHAPES)
def test_every_cost_is_loaded_ahead_from_its_own_row(itemsize, t1, t2, n1,
                                                     n2):
    r = rows_per_thread(t1)
    assert t1 <= r * NTHREADS                     # every row has a thread
    lw = window(r, itemsize)
    for i in sorted({1, n1 // 2, n1 - 1} - {0}):
        if i >= n1:
            continue
        issued = window_schedule(i, n1, n2, lw)
        for at, cols in issued.values():
            # on diagonals the whole CTA shares, and no address leaves the
            # row: i*T2 + col < (i + 1)*T2, only the valid columns
            assert at == -1 or at % lw == 0
            assert all(1 <= c < n2 <= t2 for c in cols)
        for j in range(1, n2):                    # every valid cell
            k = i + j
            kw, lane = k - k % lw, k % lw
            at, cols = issued[kw]
            # the window's lane k % LW holds the cell's own column, loaded
            # a whole window ahead (the first window before the loop)
            assert kw - i + lane == j and j in cols
            assert (at == -1 and k >= 1) or k - at >= lw, (j, at)


@pytest.mark.parametrize("t1", [1, 1024, 1025, 2048, 4096])
def test_the_live_warps_cover_every_row_below_n1(t1):
    n1 = np.arange(1, t1 + 1)
    live = 32 * ((np.minimum(n1, NTHREADS) + 31) // 32)
    assert (live % 32 == 0).all() and (live <= NTHREADS).all()
    # the last live warp holds a row < n1: no warp joins with nothing to do
    assert (live - 32 < np.minimum(n1, NTHREADS)).all()
    for n in sorted({1, 2, 31, 32, 33, 730, 1023, 1024, t1} & set(n1)):
        rows = np.arange(n)
        assert (rows % NTHREADS < live[n - 1]).all(), n


# --- the choice words -----------------------------------------------------

def word_schedule(i, n2, last, choice):
    """Replay row i's choice words in ``dtw_kernel``: the stores (diagonal,
    word index, value) in order, the final flush at diagonal last + 1;
    ``choice(j)`` is cell (i, j)'s 2-bit code."""
    word, done, stores = 0, None, []
    for k0 in range(0, last + 1, 16):
        for q in range(16):
            k = k0 + q
            if q == 0 and done is not None:
                stores.append((k, *done))
                done = None
            j = k - i
            if k < 1 or k > last or not 1 <= j < n2:
                continue
            word = ((word >> 2) | (choice(j) << 30)) & 0xFFFFFFFF
            jb = j & 15
            if jb == 15 or j == n2 - 1:
                if done is not None:   # the last word right after a full one
                    stores.append((k, *done))
                done = (j >> 4, word >> (2 * (15 - jb)))
    if done is not None:
        stores.append((last + 1, *done))
    return stores


def packed_word(codes, w, n2):
    """Word w of a row as the backtrace reads it: column j's code at bits
    2(j & 15), for 1 <= j < n2; column 0's bits zero."""
    out = 0
    for j in range(max(1, 16 * w), min(16 * w + 16, n2)):
        out |= int(codes[j]) << (2 * (j & 15))
    return out


@pytest.mark.parametrize("n1,n2", [(2, 2), (3, 17), (40, 32), (24, 400),
                                   (700, 730), (600, 7), (9, 16), (9, 18)])
def test_choice_words_are_stored_once_on_shared_diagonals(n1, n2):
    rng = np.random.default_rng(n1 * 1000 + n2)
    codes = rng.integers(0, 3, size=(n1, n2))
    last = n1 + n2 - 2
    late = 0
    for i in range(1, n1):
        stores = word_schedule(i, n2, last, lambda j: int(codes[i, j]))
        assert [w for _, w, _ in stores] == list(range((n2 - 1) // 16 + 1))
        for k, w, value in stores:
            assert value == packed_word(codes[i], w, n2), (i, w)
            assert k <= last + 1                  # before the last barrier
            late += k % 16 != 0 and k != last + 1
    # off the shared diagonals only where a row's last word follows a full
    # one inside a block of 16: at most one such store a row
    assert late <= n1


# --- the backtrace --------------------------------------------------------

def pack_choices(costs, n1, n2, seed=0):
    """The kernel's choice table (K, T1, ceil(T2/16)) uint32, from the plain
    version's choices; the words the kernel never writes hold noise."""
    k, t1, t2 = costs.shape
    choices, _ = dtw_choices_plain(costs, n1, n2)
    choices = choices.numpy()
    nw = (t2 + 15) // 16
    table = np.random.default_rng(seed).integers(
        0, 2 ** 32, size=(k, t1, nw), dtype=np.uint64).astype(np.uint32)
    for u in range(k):
        a, b = int(n1[u]), int(n2[u])
        for i in range(1, a):
            codes = np.zeros(b, np.int64)
            codes[1:] = choices[u, i + np.arange(1, b), i]
            for w in range((b - 1) // 16 + 1):
                table[u, i, w] = packed_word(codes, w, b)
    return table


def walk(table, n1, n2, t1):
    """``backtrace`` of ``dtw.cu``: the word in use kept, a ring of RING
    slots that each take the words w and w − 1 of the row RING below the
    one the walk leaves, and loads on demand where the ring misses. Returns
    the alignment and counts of steps, words taken from the ring and loads
    on demand."""
    al = np.zeros(t1, np.int32)
    counts = {"steps": 0, "ring": 0, "on_demand": 0}

    def load(r, w):
        assert 1 <= r < n1 and 0 <= w < table.shape[1], (r, w)
        return int(table[r, w])

    def fill(r, w):                               # fill_slot
        # unconditional loads at row max(r, 1), words w and w − 1 (at w = 0
        # the word before the row): inside the table, and None where the
        # walk must never use them
        flat = max(r, 1) * table.shape[1] + w
        assert 1 <= flat and max(r, 1) < n1, (r, w)
        a, b = table.flat[flat], table.flat[flat - 1]
        if r < 1:
            return r, -2, None, None
        return r, w, int(a), int(b) if w > 0 else None

    def on_demand(r, w):
        counts["on_demand"] += 1
        return load(r, w)

    i, j = n1 - 1, n2 - 1
    if i <= 0 or j <= 0:
        return al, counts
    ring = [fill(i - s, j >> 4) for s in range(RING)]
    s = 0
    while True:
        row, tag, a, b = ring[s]
        assert row == i                           # slot s holds row i
        w = j >> 4
        counts["ring"] += tag == w or tag - 1 == w
        word = a if tag == w else b if tag - 1 == w else on_demand(i, w)
        while True:
            counts["steps"] += 1
            al[i] = j
            c = (word >> (2 * (j & 15))) & 3
            if c != 1:
                break
            j -= 1
            if j == 0:
                return al, counts
            if j & 15 == 15:                      # left into word w − 1
                w -= 1
                counts["ring"] += tag - 1 == w
                word = b if tag - 1 == w else on_demand(i, w)
        if c == 2:
            j -= 1
        ring[s] = fill(i - RING, j >> 4)
        i -= 1
        if i == 0 or j == 0:
            return al, counts
        s = (s + 1) % RING


def _walk_all(costs, n1, n2):
    k, t1, t2 = costs.shape
    n1c, n2c = np.clip(n1, 1, t1), np.clip(n2, 1, t2)
    table = pack_choices(costs, torch.from_numpy(n1), torch.from_numpy(n2))
    ref, _ = dtw_align_batch_plain(costs, torch.from_numpy(n1),
                                   torch.from_numpy(n2))
    total = {}
    for u in range(k):
        al, counts = walk(table[u], int(n1c[u]), int(n2c[u]), t1)
        np.testing.assert_array_equal(al, ref[u].numpy(),
                                      err_msg=f"utterance {u}")
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
    return total


# the cases of test_torch_dtw.py: padded lengths and the n ∈ {1, 2} edges
N1 = np.array([40, 17, 2, 1, 1, 2, 33], np.int32)
N2 = np.array([32, 9, 2, 1, 5, 1, 32], np.int32)


def _uniform(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.1, 2.0, size=shape)
                            .astype(np.float32))


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_the_backtrace_walk_gives_the_plain_alignment(seed):
    _walk_all(_uniform(seed, (len(N1), 40, 32)), N1, N2)


def test_the_backtrace_walk_on_integer_near_ties():
    costs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 3, size=(len(N1), 40, 32)).astype(np.float32))
    _walk_all(costs, N1, N2)


@pytest.mark.parametrize("n1,n2", [(1, 1), (1, 2), (2, 1), (2, 2), (2, 40),
                                   (40, 2), (5, 40)])  # (5, 40): RING + 1 rows
def test_the_backtrace_walk_on_the_edges(n1, n2):
    _walk_all(_uniform(n1 * 100 + n2, (1, 40, 40)), np.array([n1], np.int32),
              np.array([n2], np.int32))


def test_the_backtrace_walk_with_long_left_runs():
    # n2 ≫ n1: left runs cross several words of a row, past the ring's two
    counts = _walk_all(_uniform(5, (2, 24, 400)), np.array([24, 9], np.int32),
                       np.array([400, 333], np.int32))
    assert counts["on_demand"] > 0, counts


def test_the_backtrace_walk_at_the_training_shape():
    # the trainer's t_cap, lengths in the silent slice's range: the ring
    # holds the word of every row the walk enters (1965 steps, 1639 words
    # from the ring, no load on demand)
    n1 = np.array([730, 282, 611], np.int32)
    n2 = np.array([700, 300, 540], np.int32)
    counts = _walk_all(_uniform(8, (3, 1024, 1024)), n1, n2)
    assert max(n1) <= counts["steps"] <= sum(n1 + n2), counts
    assert counts["ring"] >= sum(n1 - 1) and counts["on_demand"] == 0, counts
