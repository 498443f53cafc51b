"""The AdamW kernels' wrapper on the CPU (``ops/adamw.py``): the chunk
planner and the launches' runs of leaves, held to a Python rendering of
the kernels' walk (the constants read from ``csrc/adamw.cu``), and
``FusedAdamW`` on CPU tensors taking the per-leaf loop without counting a
launch. The kernels themselves are held bit for bit to the loop on the
card (``tests/test_torch_kernels_cuda.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.ops import adamw
from silent_speech_tpu_torch.ops.adamw import plan_chunks, plan_launches
from silent_speech_tpu_torch.train.state import FusedAdamW

SOURCE = (Path(adamw.__file__).resolve().parent.parent / "csrc"
          / "adamw.cu").read_text()


def _constant(name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);", SOURCE).group(1)


THREADS, UNROLL = int(_constant("THREADS")), int(_constant("UNROLL"))
assert _constant("CHUNK") == "THREADS * 4 * UNROLL"   # one pass of a CTA
CHUNK = THREADS * 4 * UNROLL
MAX_LEAVES = int(_constant("MAX_LEAVES"))

# the transduction model's leaf sizes (120 leaves, 54,187,136 elements)
TRANSDUCTION = ([48, 80] + [768] * 58 + [3072] * 6
                + [6144, 18432, 36864, 61440] + [152832] * 6
                + [589824] * 27 + [1769472] * 5 + [2359296] * 12)


def _kernel_walk(sizes, first, chunk, ctas):
    """The elements each leaf's chunks touch as the kernels walk them: CTA
    b takes the chunks b, b + ctas, ...; finds each one's leaf by walking
    the first chunks forward from the last; takes [base, stop) of it, each
    thread UNROLL groups of 4 from ``base + 4·(thread + u·THREADS)``, the
    ragged group masked."""
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    for b in range(ctas):
        k = 0
        for c in range(b, first[-1], ctas):
            while k + 1 < len(sizes) and first[k + 1] <= c:
                k += 1
            base = (c - first[k]) * chunk
            stop = min(base + chunk, sizes[k])
            assert 0 <= base < stop <= sizes[k]     # never across a leaf
            for t in range(THREADS):
                for u in range(UNROLL):
                    i = base + 4 * (t + u * THREADS)
                    seen[k][i: min(i + 4, stop)] += 1
    return seen


@pytest.mark.parametrize("sizes,chunk,ctas", [
    ([1, 3, 48, 80, 1027, 9000], CHUNK, 264),
    ([0, 5, 0, 4096, 4097, 0], CHUNK, 3),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9], 4, 2),
    ([0, 0, 7, 0], 4, 1),
    ([13] * 40, 8, 7),
    ([CHUNK * 3 + 1, 2 * CHUNK], CHUNK, 4),
], ids=["ragged", "empty-leaves", "chunk4", "one-leaf", "many", "whole"])
def test_the_kernel_walk_covers_every_element_once(sizes, chunk, ctas):
    first = plan_chunks(sizes, chunk)
    assert len(first) == len(sizes) + 1 and first[0] == 0
    assert all((s == 1).all() for s in _kernel_walk(sizes, first, chunk,
                                                    ctas))


def test_the_transduction_model_s_chunks():
    first = plan_chunks(TRANSDUCTION, CHUNK)
    assert len(TRANSDUCTION) == 120 and sum(TRANSDUCTION) == 54_187_136
    assert first[-1] == sum(-(-n // CHUNK) for n in TRANSDUCTION)
    assert all(b - a == -(-n // CHUNK)
               for a, b, n in zip(first, first[1:], TRANSDUCTION))


@pytest.mark.parametrize("n_leaves,per_launch", [
    (120, MAX_LEAVES), (7, 3), (6, 3), (9, 1), (0, 4)])
def test_the_launches_split_the_leaves(n_leaves, per_launch):
    sizes = [(k * 977) % 5000 for k in range(n_leaves)]   # some empty
    first = plan_chunks(sizes, 1024)
    launches = plan_launches(first, per_launch)
    covered = []
    for leaf0, leaf1 in launches:
        assert 0 < leaf1 - leaf0 <= per_launch
        assert first[leaf1] > first[leaf0]
        covered += [k for k in range(leaf0, leaf1) if sizes[k]]
    assert covered == [k for k in range(n_leaves) if sizes[k]]
    assert len(launches) <= -(-n_leaves // per_launch)


def test_one_launch_holds_every_trainer_s_leaves():
    # transduction 120, recognition 118, the vocoder's generator 156 and
    # discriminators 108 leaves: one launch each
    assert MAX_LEAVES >= 156
    assert plan_launches(plan_chunks(TRANSDUCTION, CHUNK),
                         MAX_LEAVES) == [(0, 120)]


def test_a_chunk_not_of_whole_groups_is_refused():
    with pytest.raises(ValueError, match="multiple of 4"):
        plan_chunks([10], 6)


def test_the_kernels_refuse_cpu_tensors():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="CUDA"):
        adamw.Leaves(p, [torch.zeros(3)], [torch.zeros(3)], [])


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("moment_dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_loop_without_a_launch(grad_accum,
                                                    moment_dtype):
    g = torch.Generator().manual_seed(3)
    params = [torch.nn.Parameter(torch.randn(n, generator=g))
              for n in (5, 7)]
    start = [p.detach().clone() for p in params]
    opt = FusedAdamW(params, weight_decay=1e-7, moment_dtype=moment_dtype,
                     grad_accum=grad_accum)
    before = adamw.adamw_update.launches, adamw.adamw_fold.launches
    for step in range(4):
        params[0].grad = torch.randn(5, generator=g)
        params[1].grad = None if step == 1 else torch.randn(7, generator=g)
        assert opt.step(1e-3 * (step + 1)) == ((step + 1) % grad_accum == 0)
    assert opt._on_card is None
    assert (adamw.adamw_update.launches, adamw.adamw_fold.launches) == before
    assert (opt.count, opt.mini_step) == (4 // grad_accum, 0)
    assert all(not torch.equal(p, s) for p, s in zip(params, start))
    assert all(m.dtype == moment_dtype for m in opt.mu + opt.nu)
