"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA card and nvcc; skips without a card. Imports neither JAX nor
the JAX package, so it runs on a machine without them::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.config import ModelConfig
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.ops.dtw import (dtw_align_batch,
                                             dtw_align_batch_plain)
from silent_speech_tpu_torch.ops.rel_attention import (
    attention_drop_threshold, rel_attention, rel_attention_bwd,
    rel_attention_plain)

DROP = attention_drop_threshold(0.2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # f32 references in full f32, not TF32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _inputs(t, dtype, seed=0, h=8, dh=96, m=100, b=1):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, dh, generator=g) for _ in range(3))
    e = torch.randn(h, 2 * m - 1, dh, generator=g) * dh ** -0.5
    return [x.to("cuda", dtype) for x in (q, k, v, e)]


@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-4),
    # both compute in f32; a bf16 output may differ by one rounding step
    (torch.bfloat16, 2e-2),
])
@pytest.mark.parametrize("t,valid_len", [(256, 256), (256, 37), (64, 64),
                                         (1024, 1024), (200, 150)])
def test_rel_attention_kernel_matches_plain(card, dtype, atol, t, valid_len):
    q, k, v, e = _inputs(t, dtype)
    before = rel_attention.launches
    out = rel_attention(q, k, v, e, 100, valid_len)
    torch.cuda.synchronize()
    assert rel_attention.launches == before + 1
    ref = rel_attention_plain(q, k, v, e, 100, valid_len)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-4),
    (torch.bfloat16, 2e-2),   # one bf16 rounding step of the output
])
@pytest.mark.parametrize("b,t", [(4, 200), (1, 1024)])
def test_rel_attention_kernel_with_dropout_matches_plain(card, dtype, atol,
                                                         b, t):
    q, k, v, e = _inputs(t, dtype, b=b)
    out = rel_attention(q, k, v, e, 100, None, 99, DROP)
    ref = rel_attention_plain(q, k, v, e, 100, None, 99, DROP)
    # the same hash draws the same mask: compared value for value
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,rel", [
    (torch.float32, 1e-4),    # f32 both; dE sums 4·200 rows with atomics
    (torch.bfloat16, 1e-2),   # f32 inside, one bf16 rounding of each grad
])
@pytest.mark.parametrize("drop", [0, DROP], ids=["nodrop", "drop"])
@pytest.mark.parametrize("valid_len", [None, 150])
def test_rel_attention_backward_kernel_matches_autograd(card, dtype, rel,
                                                        drop, valid_len):
    q, k, v, e = _inputs(200, dtype, seed=3, b=4)
    g = torch.Generator().manual_seed(4)
    dout = torch.randn(q.shape, generator=g).to("cuda", dtype)
    before = rel_attention_bwd.launches
    ours = rel_attention_bwd(q, k, v, e, dout, 100, valid_len, 7, drop)
    torch.cuda.synchronize()
    assert rel_attention_bwd.launches == before + 1
    xs = [x.detach().requires_grad_() for x in (q, k, v, e)]
    rel_attention_plain(*xs, 100, valid_len, 7, drop).backward(dout)
    for name, o, x in zip(("dq", "dk", "dv", "de"), ours, xs):
        assert o.dtype == x.dtype and o.shape == x.shape
        scale = x.grad.float().abs().max().item()
        torch.testing.assert_close(o.float(), x.grad.float(), rtol=0,
                                   atol=rel * scale, msg=name)


def test_autograd_runs_both_attention_kernels(card):
    q, k, v, e = (x.requires_grad_() for x in _inputs(200, torch.float32,
                                                      b=2))
    f0, b0 = rel_attention.launches, rel_attention_bwd.launches
    rel_attention(q, k, v, e, 100, None, 5, DROP).sum().backward()
    assert (rel_attention.launches, rel_attention_bwd.launches) == (
        f0 + 1, b0 + 1)
    assert all(x.grad is not None for x in (q, k, v, e))


def _dtw_case(seed=0, k=16, t1=1024, t2=1024):
    rng = np.random.default_rng(seed)
    costs = torch.from_numpy(rng.uniform(0.1, 2.0, size=(k, t1, t2)).astype(
        np.float32)).cuda()
    n1 = rng.integers(t1 * 3 // 5, t1, size=k)
    n2 = rng.integers(t2 * 3 // 5, t2, size=k)
    n1[:4], n2[:4] = (1, 1, 2, 2), (1, 2, 1, 2)   # the edge cases
    n1[-1], n2[-1] = t1, t2                        # the whole matrix
    return (costs, torch.from_numpy(n1).int().cuda(),
            torch.from_numpy(n2).int().cuda())


@pytest.mark.parametrize("dtype,t1,t2", [
    (torch.float32, 1024, 1024), (torch.bfloat16, 1024, 1024),
    (torch.float32, 2048, 1536),   # beyond the trainer's t_cap of 1024
])
def test_dtw_kernel_matches_plain(card, dtype, t1, t2):
    costs, n1, n2 = _dtw_case(k=16 if t1 == 1024 else 6, t1=t1, t2=t2)
    costs = costs.to(dtype)
    before = dtw_align_batch.launches
    align, cost = dtw_align_batch(costs, n1, n2)
    torch.cuda.synchronize()
    assert dtw_align_batch.launches == before + 1
    ref_align, ref_cost = dtw_align_batch_plain(costs, n1, n2)
    torch.testing.assert_close(align, ref_align, rtol=0, atol=0)
    # the same per-cell f32 recurrence: equal, held to 1e-5 relative
    torch.testing.assert_close(cost, ref_cost, rtol=1e-5, atol=0)
    dp_align, dp_cost = dtw_align_batch(costs, n1, n2, dp_only=True)
    torch.testing.assert_close(dp_cost, cost, rtol=0, atol=0)
    assert int(dp_align.abs().sum()) == 0


def test_rel_attention_rejects_non_contiguous_cuda_input(card):
    q, k, v, e = _inputs(64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        rel_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                      e, 100)


def test_encoder_forward_on_card_matches_cpu(card):
    cfg = ModelConfig(model_size=192, num_layers=2, num_heads=2,
                      dim_feedforward=384, relative_positional_distance=100,
                      compute_dtype="float32")
    model = EMGEncoder(80, 48, cfg).init_weights(
        torch.Generator().manual_seed(0)).eval()
    raw = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8 * 256, 8)).astype(np.float32))
    with torch.no_grad():
        ref = model(raw, valid_len=200)
        out = model.to("cuda")(raw.to("cuda"), valid_len=200)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.cpu(), r, rtol=0, atol=1e-4)
