"""The port's DTW (plain version, which CPU tensors take) vs the JAX
package: the ``lax.scan`` DTW (same per-cell recurrence: alignment and
path cost bit for bit), the Pallas kernel in interpret mode (same
alignment; its cumsum form rounds the cost differently) and the float64
numpy oracle."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from silent_speech_tpu.ops.dtw import (
    align_from_distances_numpy as jax_oracle, dtw_align_batch_scan)
from silent_speech_tpu.ops.pallas.dtw_kernel import pallas_dtw_align_batch
from silent_speech_tpu_torch.ops.dtw import (
    align_from_distances_numpy, dtw_align_batch, dtw_align_batch_plain)

# padded lengths, the edge cases n ∈ {1, 2}, and a full-size utterance
N1 = np.array([40, 17, 2, 1, 1, 2, 33], np.int32)
N2 = np.array([32, 9, 2, 1, 5, 1, 32], np.int32)


def _costs(seed=11, k=len(N1), t1=40, t2=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 2.0, size=(k, t1, t2)).astype(np.float32)


def _ours(costs, n1=N1, n2=N2, **kw):
    align, cost = dtw_align_batch(torch.from_numpy(costs),
                                  torch.from_numpy(n1), torch.from_numpy(n2),
                                  **kw)
    assert align.dtype == torch.int32 and cost.dtype == torch.float32
    return align.numpy(), cost.numpy()


@pytest.mark.parametrize("seed", [11, 12])
def test_matches_the_scan_bit_for_bit(seed):
    costs = _costs(seed)
    align, cost = _ours(costs)
    ref_align, ref_cost = dtw_align_batch_scan(
        jnp.asarray(costs), jnp.asarray(N1), jnp.asarray(N2))
    np.testing.assert_array_equal(align, np.asarray(ref_align))
    np.testing.assert_array_equal(cost, np.asarray(ref_cost))


def test_matches_the_pallas_kernel_in_interpret_mode():
    costs = _costs(13)
    align, cost = _ours(costs)
    ref_align, ref_cost = pallas_dtw_align_batch(
        jnp.asarray(costs), jnp.asarray(N1), jnp.asarray(N2),
        interpret=True)
    np.testing.assert_array_equal(align, np.asarray(ref_align))
    finite = np.isfinite(cost)
    # the kernel's cumsum/cummin form sums in another order
    np.testing.assert_allclose(cost[finite], np.asarray(ref_cost)[finite],
                               rtol=1e-5)


def test_matches_the_numpy_oracles():
    costs = _costs(14)
    align, _ = _ours(costs)
    for u in range(len(N1)):
        block = costs[u, :N1[u], :N2[u]]
        expected = align_from_distances_numpy(block)
        assert expected == jax_oracle(block)
        np.testing.assert_array_equal(align[u, :N1[u]], expected,
                                      err_msg=f"utterance {u}")
        assert (align[u, N1[u]:] == 0).all()


def test_near_ties_follow_the_first_minimum():
    # integer costs make many exact ties between up, left and diag
    costs = np.random.default_rng(3).integers(
        0, 3, size=(len(N1), 40, 32)).astype(np.float32)
    align, cost = _ours(costs)
    ref_align, ref_cost = dtw_align_batch_scan(
        jnp.asarray(costs), jnp.asarray(N1), jnp.asarray(N2))
    np.testing.assert_array_equal(align, np.asarray(ref_align))
    np.testing.assert_array_equal(cost, np.asarray(ref_cost))


def test_bf16_costs_run_the_dp_in_f32():
    costs = torch.from_numpy(_costs(15)).to(torch.bfloat16)
    align, cost = dtw_align_batch(costs, torch.from_numpy(N1),
                                  torch.from_numpy(N2))
    ref_align, ref_cost = dtw_align_batch_scan(
        jnp.asarray(costs.float().numpy()), jnp.asarray(N1), jnp.asarray(N2))
    np.testing.assert_array_equal(align.numpy(), np.asarray(ref_align))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(ref_cost))


def test_dp_only_gives_the_same_cost_and_no_alignment():
    costs = _costs(16)
    _, cost = _ours(costs)
    align0, cost0 = _ours(costs, dp_only=True)
    np.testing.assert_array_equal(cost0, cost)
    assert (align0 == 0).all()


def test_cpu_tensors_take_the_plain_version_without_counting():
    costs = torch.from_numpy(_costs(17))
    dtw_align_batch.launches = 0
    ours = dtw_align_batch(costs, torch.from_numpy(N1), torch.from_numpy(N2))
    ref = dtw_align_batch_plain(costs, torch.from_numpy(N1),
                                torch.from_numpy(N2))
    assert dtw_align_batch.launches == 0
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["rank", "lengths", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    costs = torch.from_numpy(_costs(18))
    n1, n2 = torch.from_numpy(N1), torch.from_numpy(N2)
    if case == "rank":
        costs = costs[0]
    elif case == "lengths":
        n1 = n1[:-1]
    else:  # a non-CPU tensor never takes the plain version
        costs, n1, n2 = (x.to("meta") for x in (costs, n1, n2))
    with pytest.raises(ValueError):
        dtw_align_batch(costs, n1, n2)
