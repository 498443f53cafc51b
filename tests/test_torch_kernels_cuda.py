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
from silent_speech_tpu_torch.ops import adamw
from silent_speech_tpu_torch.ops import rel_attention as attention_module
from silent_speech_tpu_torch.ops.ctc import (MAX_LABELS, ctc_grad_plain,
                                             ctc_nll, ctc_nll_plain)
from silent_speech_tpu_torch.ops.dropout import (
    Shard, _launch_relu_bwd, dropout_threshold, mask_scale, mask_scale_plain,
    regen_dropout, relu_dropout, relu_dropout_backward_plain)
from silent_speech_tpu_torch.ops.dtw import (MAX_ROWS, dtw_align_batch,
                                             dtw_align_batch_plain)
from silent_speech_tpu_torch.ops.rel_attention import (
    _staged_bwd, attention_drop_threshold, rel_attention, rel_attention_bwd,
    rel_attention_bwd_staged_plain, rel_attention_plain)
from silent_speech_tpu_torch.train.state import FusedAdamW

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


@pytest.mark.parametrize("b,t,valid_len,m,drop", [
    (1, 37, 20, 100, 0),        # T not a multiple of 16, T < 2m − 1
    (1, 64, 64, 100, 0),
    (2, 200, 150, 100, 0),      # an utterance and its padding
    (2, 300, 250, 20, DROP),    # T above the band's columns (nb = 96)
    (1, 1024, 700, 100, 0),     # serving's buckets
    (1, 2048, 1500, 100, 0),
    (120, 200, 200, 100, DROP),  # the training shape
])
def test_rel_attention_bf16_forward_matches_both_plain_versions(
        card, b, t, valid_len, m, drop):
    q, k, v, e = _inputs(t, torch.bfloat16, seed=t, b=b, m=m)
    out = rel_attention(q, k, v, e, m, valid_len, 21, drop)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    # the kernel's own rounding point: P' to bf16 before ·V; the outputs
    # differ by f32 summation order and one bf16 rounding of O
    mirror = rel_attention_plain(q, k, v, e, m, valid_len, 21, drop,
                                 store_dtype=torch.bfloat16)
    torch.testing.assert_close(out.float(), mirror.float(), rtol=0,
                               atol=2e-2)
    # the f32 plain version: P' unrounded, a rounding step of P' more
    ref = rel_attention_plain(q, k, v, e, m, valid_len, 21, drop)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)


def test_rel_attention_forward_bf16_is_bit_equal_between_calls(card):
    q, k, v, e = _inputs(200, torch.bfloat16, seed=12, b=4)
    first = rel_attention(q, k, v, e, 100, None, 5, DROP)
    second = rel_attention(q, k, v, e, 100, None, 5, DROP)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype,source", [
    (torch.float32, "rel_attention_fwd"),
    (torch.bfloat16, "rel_attention_fwd_wmma"),
])
def test_rel_attention_forward_route_counts_one_launch_per_call(
        card, monkeypatch, dtype, source):
    opened = []

    def spy(name):
        opened.append(name)
        return real(name)

    real = attention_module._library
    monkeypatch.setattr(attention_module, "_library", spy)
    q, k, v, e = _inputs(64, dtype)
    before = rel_attention.launches
    for _ in range(2):
        rel_attention(q, k, v, e, 100)
    assert rel_attention.launches == before + 2
    assert opened == [source, source]


@pytest.mark.parametrize("lib_name,name,args", [
    ("rel_attention_fwd", "rel_attention_fwd", 5),   # q, k, v, e, o
    # the backward's first stage: + dout and the scratch P', dS, dR
    ("rel_attention_bwd", "rel_attention_bwd_scores", 8),
])
def test_f32_kernel_entries_reject_bf16(card, lib_name, name, args):
    lib = attention_module._library(lib_name)
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.zeros(1, device="cuda")
    # dims, valid_len, scale, seed, threshold, 1/keep, the cells' offsets
    # (0, 0, H), then is_bf16 = 1
    err = getattr(lib, name)(*[x.data_ptr()] * args, 1, 1, 16, 16, 1, 16,
                             0.25, 0, 0, 1.0, 0, 0, 1, 1, stream)
    assert err == 1   # cudaErrorInvalidValue, before any launch


def test_rel_attention_forward_f32_is_bit_equal_between_calls(card):
    q, k, v, e = _inputs(200, torch.float32, seed=12, b=4)
    first = rel_attention(q, k, v, e, 100, None, 5, DROP)
    second = rel_attention(q, k, v, e, 100, None, 5, DROP)
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,t,valid_len,m,drop", [
    (120, 200, 200, 100, DROP),   # the training shape
    (2, 300, 250, 130, DROP),     # a window past 105: two panels of R, S
    (1, 2048, 1500, 100, 0),      # serving's largest bucket
    (1, 2048, 2048, 163, DROP),   # the parent's widest window at d_h = 96
])
def test_rel_attention_f32_forward_matches_plain(card, b, t, valid_len, m,
                                                 drop):
    q, k, v, e = _inputs(t, torch.float32, seed=t + m, b=b, m=m)
    before = rel_attention.f32_launches
    out = rel_attention(q, k, v, e, m, valid_len, 21, drop)
    torch.cuda.synchronize()
    assert rel_attention.f32_launches == before + 1
    ref = rel_attention_plain(q, k, v, e, m, valid_len, 21, drop)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dh", [16, 48, 64, 80, 128])
def test_rel_attention_f32_forward_at_every_head_width(card, dh):
    # one kernel a width (d_h / 16 columns a thread in P'.V)
    q, k, v, e = _inputs(200, torch.float32, seed=dh, b=2, h=3, dh=dh)
    out = rel_attention(q, k, v, e, 100, 150, 8, DROP, b_offset=1,
                        h_offset=2, h_total=6)
    ref = rel_attention_plain(q, k, v, e, 100, 150, 8, DROP, b_offset=1,
                              h_offset=2, h_total=6)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_rel_attention_f32_forward_raises_past_the_cards_shared_memory(card):
    # a band of 1456 keys at T = 2048: its scores need 237,568 bytes
    q, k, v, e = _inputs(2048, torch.float32, h=1, m=700)
    with pytest.raises(ValueError, match="shared memory"):
        rel_attention(q, k, v, e, 700)


@pytest.mark.parametrize("b", [4, 120])
def test_rel_attention_backward_f32_is_bit_equal_between_calls(card, b):
    q, k, v, e = _inputs(200, torch.float32, seed=13, b=b)
    g = torch.Generator().manual_seed(14)
    dout = torch.randn(q.shape, generator=g).to("cuda")
    first = rel_attention_bwd(q, k, v, e, dout, 100, None, 5, DROP)
    second = rel_attention_bwd(q, k, v, e, dout, 100, None, 5, DROP)
    for name, x, y in zip(("dq", "dk", "dv", "de"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("dtype,rel", [
    (torch.float32, 1e-4),    # f32 both; dE sums 4·200 rows in another order
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


@pytest.mark.parametrize("dtype,rel", [
    (torch.float32, 1e-4),
    (torch.bfloat16, 1e-2),
])
@pytest.mark.parametrize("t,valid_len,m", [
    (37, 20, 100),   # T not a multiple of 16, the whole matrix in window
    (37, 20, 8),     # and a band narrower than T
    (300, 250, 20),  # several key tiles per band
])
def test_rel_attention_backward_kernel_ragged_shapes(card, dtype, rel, t,
                                                     valid_len, m):
    q, k, v, e = _inputs(t, dtype, seed=5, b=2, m=m)
    g = torch.Generator().manual_seed(6)
    dout = torch.randn(q.shape, generator=g).to("cuda", dtype)
    ours = rel_attention_bwd(q, k, v, e, dout, m, valid_len, 3, DROP)
    xs = [x.detach().requires_grad_() for x in (q, k, v, e)]
    rel_attention_plain(*xs, m, valid_len, 3, DROP).backward(dout)
    for name, o, x in zip(("dq", "dk", "dv", "de"), ours, xs):
        scale = x.grad.float().abs().max().item()
        torch.testing.assert_close(o.float(), x.grad.float(), rtol=0,
                                   atol=rel * scale, msg=name)


def test_rel_attention_backward_bf16_is_bit_equal_between_calls(card):
    q, k, v, e = _inputs(200, torch.bfloat16, seed=8, b=4)
    g = torch.Generator().manual_seed(9)
    dout = torch.randn(q.shape, generator=g).to("cuda", torch.bfloat16)
    first = rel_attention_bwd(q, k, v, e, dout, 100, None, 5, DROP)
    second = rel_attention_bwd(q, k, v, e, dout, 100, None, 5, DROP)
    for name, a, b in zip(("dq", "dk", "dv", "de"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_attention_backward_counts_one_launch_per_call(card, dtype):
    q, k, v, e = _inputs(64, dtype, b=1)
    before = rel_attention_bwd.launches
    for _ in range(2):
        rel_attention_bwd(q, k, v, e, torch.ones_like(q), 100)
    assert rel_attention_bwd.launches == before + 2


def test_rel_attention_backward_bf16_scratch_matches_the_staged_mirror(card):
    t, m, valid_len = 200, 100, 150
    q, k, v, e = _inputs(t, torch.bfloat16, seed=10, b=2, m=m)
    g = torch.Generator().manual_seed(11)
    dout = torch.randn(q.shape, generator=g).to("cuda", torch.bfloat16)
    _, stages, scratch = _staged_bwd(q, k, v, e, dout, m, valid_len, 4, DROP)
    stages[0][1]()          # stage A alone: P', dS and dR
    _, ref = rel_attention_bwd_staged_plain(
        q, k, v, e, dout, m, valid_len, 4, DROP, store_dtype=torch.bfloat16,
        return_scratch=True)
    w = 2 * m - 1
    for name, ours, r in zip(("P'", "dS", "dR"), scratch, ref):
        cols = w if name == "dR" else t
        # both round the same f32 value to bf16; f32 sums in another order
        # may flip the rounding of a cell by one step
        torch.testing.assert_close(ours[:, :, :t, :cols].float(), r,
                                   rtol=0, atol=1e-2 * r.abs().max().item(),
                                   msg=name)
        assert not ours[:, :, t:].float().abs().any(), name
        assert not ours[:, :, :, cols:].float().abs().any(), name


def test_rel_attention_backward_f32_scratch_matches_the_staged_mirror(card):
    t, m, valid_len = 200, 100, 150
    q, k, v, e = _inputs(t, torch.float32, seed=10, b=2, m=m)
    g = torch.Generator().manual_seed(11)
    dout = torch.randn(q.shape, generator=g).to("cuda")
    _, stages, scratch = _staged_bwd(q, k, v, e, dout, m, valid_len, 4, DROP)
    stages[0][1]()          # stage A alone: P', dS and dR in f32
    _, ref = rel_attention_bwd_staged_plain(
        q, k, v, e, dout, m, valid_len, 4, DROP, return_scratch=True)
    w = 2 * m - 1
    for name, ours, r in zip(("P'", "dS", "dR"), scratch, ref):
        cols = w if name == "dR" else t
        assert ours.dtype == torch.float32
        # f32 both; the products and D sum in another order
        torch.testing.assert_close(ours[:, :, :t, :cols], r, rtol=0,
                                   atol=1e-4 * r.abs().max().item(),
                                   msg=name)
        assert not ours[:, :, t:].abs().any(), name
        assert not ours[:, :, :, cols:].abs().any(), name


@pytest.mark.parametrize("drop", [0, DROP], ids=["nodrop", "drop"])
def test_rel_attention_backward_f32_at_the_recognition_micro_step(card,
                                                                   drop):
    # a recognition micro-step's B=64 at T=200: against autograd through
    # the plain version, bit-equal between calls, one launch a call
    q, k, v, e = _inputs(200, torch.float32, seed=15, b=64)
    g = torch.Generator().manual_seed(16)
    dout = torch.randn(q.shape, generator=g).to("cuda")
    before = rel_attention_bwd.f32_launches
    ours = rel_attention_bwd(q, k, v, e, dout, 100, None, 9, drop)
    again = rel_attention_bwd(q, k, v, e, dout, 100, None, 9, drop)
    torch.cuda.synchronize()
    assert rel_attention_bwd.f32_launches == before + 2
    xs = [x.detach().requires_grad_() for x in (q, k, v, e)]
    rel_attention_plain(*xs, 100, None, 9, drop).backward(dout)
    for name, o, o2, x in zip(("dq", "dk", "dv", "de"), ours, again, xs):
        assert torch.equal(o, o2), name
        torch.testing.assert_close(o, x.grad, rtol=0,
                                   atol=1e-4 * x.grad.abs().max().item(),
                                   msg=name)


def test_rel_attention_backward_f32_raises_past_its_band(card):
    q, k, v, e = _inputs(300, torch.float32, m=106)
    with pytest.raises(ValueError, match="columns"):
        rel_attention_bwd(q, k, v, e, torch.ones_like(q), 106)


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


def _dtw_matches_plain(costs, n1, n2):
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
    return align, cost


@pytest.mark.parametrize("dtype,t1,t2", [
    (torch.float32, 1024, 1024), (torch.bfloat16, 1024, 1024),
    (torch.float32, 2048, 1536),   # beyond the trainer's t_cap of 1024
    # rows not 16-byte aligned: the costs come by scalar loads
    (torch.float32, 1000, 1001), (torch.bfloat16, 1000, 1001),
    (torch.bfloat16, 4096, 1024),  # 4 rows a thread, the kernel's limit
])
def test_dtw_kernel_matches_plain(card, dtype, t1, t2):
    k = {1024: 16, 4096: 5}.get(t1, 6)
    costs, n1, n2 = _dtw_case(k=k, t1=t1, t2=t2)
    _dtw_matches_plain(costs.to(dtype), n1, n2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtw_kernel_on_integer_ties_is_bit_equal(card, dtype):
    # integer costs (exact in bf16) make many exact ties between up, left
    # and diag: the first minimum must be the plain version's
    _, n1, n2 = _dtw_case(seed=3)
    rng = np.random.default_rng(4)
    costs = torch.from_numpy(rng.integers(0, 3, size=(16, 1024, 1024))
                             .astype(np.float32)).cuda().to(dtype)
    _, cost = _dtw_matches_plain(costs, n1, n2)
    ref = dtw_align_batch_plain(costs, n1, n2)[1]
    torch.testing.assert_close(cost, ref, rtol=0, atol=0)


def test_dtw_kernel_with_one_live_warp(card):
    # every n1 <= 32: one warp joins the per-diagonal barrier
    costs, _, _ = _dtw_case(seed=5)
    rng = np.random.default_rng(6)
    n1 = torch.from_numpy(rng.integers(1, 33, size=16)).int().cuda()
    n2 = torch.from_numpy(rng.integers(1, 1025, size=16)).int().cuda()
    n1[0], n2[0] = 32, 1024
    _dtw_matches_plain(costs.to(torch.bfloat16), n1, n2)


def test_dtw_kernel_is_bit_equal_between_calls(card):
    costs, n1, n2 = _dtw_case(seed=7)
    costs = costs.to(torch.bfloat16)
    first = dtw_align_batch(costs, n1, n2)
    again = dtw_align_batch(costs, n1, n2)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_dtw_kernel_rejects_rows_past_its_limit(card):
    costs = torch.zeros((1, MAX_ROWS + 1, 16), device="cuda")
    n = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="4096"):
        dtw_align_batch(costs, n, n)


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


@pytest.mark.parametrize("t1,t2", [(1, 1), (731, 677), (33, 1000),
                                   (1000, 33), (4096, 517)])
def test_dtw_kernel_at_one_utterance_in_f32(card, t1, t2):
    # get_aligned_prediction's shape: K = 1, f32 costs, odd lengths
    rng = np.random.default_rng(t1 + t2)
    costs = torch.from_numpy(rng.uniform(0.1, 2.0, size=(1, t1, t2))
                             .astype(np.float32)).cuda()
    n1, n2 = (torch.tensor([n], dtype=torch.int32, device="cuda")
              for n in (t1, t2))
    _dtw_matches_plain(costs, n1, n2)


def _tiny_trainer(device):
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer

    cfg = ModelConfig(model_size=64, num_layers=2, num_heads=2,
                      dim_feedforward=128, relative_positional_distance=16,
                      compute_dtype="float32")
    trainer = TransductionTrainer(cfg, device=device)
    trainer.init_state(0)
    return trainer


def _silent_example(t=77, t_tgt=83):
    rng = np.random.default_rng(1)
    return {"emg": np.zeros((t, 112), np.float32),
            "raw_emg": rng.normal(size=(8 * t, 8)).astype(np.float32),
            "silent": True,
            "parallel_voiced_audio_features": rng.normal(
                size=(t_tgt, 80)).astype(np.float32)}


def test_predict_at_one_utterance_matches_the_cpu(card):
    # K1f at B = 1 with the JAX trainer's padding (77 frames → 96)
    example = _silent_example()
    cpu = _tiny_trainer("cpu").predict(example)
    before = rel_attention.launches
    out = _tiny_trainer("cuda").predict(example)
    assert rel_attention.launches == before + 2
    np.testing.assert_allclose(out, cpu, rtol=0, atol=1e-4)


def test_get_aligned_prediction_runs_the_dtw_kernel(card):
    from silent_speech_tpu_torch.data.normalizers import FeatureNormalizer

    trainer = _tiny_trainer("cuda")
    example = _silent_example()
    norm = FeatureNormalizer()
    norm.feature_means = np.full((1, 80), 0.5, np.float32)
    norm.feature_stddevs = np.float32(2.0)
    before = dtw_align_batch.launches
    out = trainer.get_aligned_prediction(example, norm)
    assert dtw_align_batch.launches == before + 1
    pred = trainer.predict(example)
    y = example["parallel_voiced_audio_features"]
    costs = np.sqrt(np.clip((pred ** 2).sum(-1)[:, None]
                            + (y ** 2).sum(-1)[None, :] - 2 * pred @ y.T,
                            1e-12, None))
    align, _ = dtw_align_batch_plain(
        torch.from_numpy(np.ascontiguousarray(costs.T))[None],
        torch.tensor([y.shape[0]]), torch.tensor([pred.shape[0]]))
    np.testing.assert_array_equal(out, norm.inverse(pred[align[0].numpy()]))
    assert out.shape == (83, 80)


def _tiny_recognizer(device):
    from silent_speech_tpu_torch.config import DataConfig
    from silent_speech_tpu_torch.train.recognition import RecognitionTrainer

    cfg = ModelConfig(model_size=64, num_layers=2, num_heads=2,
                      dim_feedforward=128, relative_positional_distance=16,
                      compute_dtype="float32")
    trainer = RecognitionTrainer(
        cfg, DataConfig(seq_len=200, chunk_bucket=1, fixed_shapes=False),
        device=device)
    trainer.init_state(0)
    return trainer


def _recognition_examples():
    rng = np.random.default_rng(2)
    out = []
    for t, text in ((150, [19, 7, 4, 36, 2, 0, 19]), (260, [3, 14, 6]),
                    (90, [0, 36, 1])):
        out.append({"emg": np.zeros((t, 112), np.float32),
                    "raw_emg": rng.normal(size=(8 * t, 8)).astype(
                        np.float32),
                    "session_ids": np.zeros(t, np.int64), "silent": False,
                    "text": "x", "text_int": np.asarray(text, np.int64),
                    "phonemes": np.zeros(t, np.int64),
                    "audio_features": np.zeros((t, 80), np.float32)})
    return out


def test_recognition_micro_step_with_kernels_matches_plain(card,
                                                           monkeypatch):
    # f32: the loss to 1e-4 relative, every gradient to 1e-3 of its
    # largest entry (sums in another order). The biases of the convs in front of a BatchNorm have
    # an exact gradient of 0 (the norm subtracts the batch mean): what
    # either run computes there is rounding noise, so they are not compared
    from silent_speech_tpu_torch.models import transformer

    batch = _tiny_recognizer("cpu")._pack(_recognition_examples())
    kernels = _tiny_recognizer("cuda")
    before = (rel_attention.launches, rel_attention_bwd.launches)
    loss = kernels.train_step(batch, 1e-3)
    torch.cuda.synchronize()
    assert (rel_attention.launches - before[0],
            rel_attention_bwd.launches - before[1]) == (2, 2)
    monkeypatch.setattr(transformer, "rel_attention", rel_attention_plain)
    plain = _tiny_recognizer("cuda")
    ref = plain.train_step(batch, 1e-3)
    assert loss.item() == pytest.approx(ref.item(), rel=1e-4)
    for (name, p), q in zip(kernels.model.named_parameters(),
                            plain.model.parameters()):
        if name.endswith(("conv1.bias", "conv2.bias", "residual_path.bias")):
            continue
        tol = 1e-3 * float(q.grad.abs().max())
        torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=tol,
                                   msg=name)
    assert kernels.optimizer.mini_step == 1


def test_recognition_validation_on_the_card_matches_the_cpu(card):
    examples = _recognition_examples()
    cpu = _tiny_recognizer("cpu").batch_logits(examples)
    before = rel_attention.launches
    out = _tiny_recognizer("cuda").batch_logits(examples)
    # one B=1 forward a utterance, 2 layers each
    assert rel_attention.launches == before + 2 * len(examples)
    for o, r in zip(out, cpu):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-4)


# ---- CTC (ops/ctc.py, csrc/ctc.cu) ------------------------------------------

# the kernel against the plain version on the card: float32, the same
# operations (only the order of the backward's sums differs). The NLL to
# 1e-6 relative (an infeasible row's ~1e5 included), the gradient to 1e-5
# of its largest entry
CTC_NLL_RTOL = 1e-6
CTC_GRAD_RTOL = 1e-5


def _ctc_case(seed, u=6, t=120, s=24, n_real=None, infeasible=False,
              repeat=False, last_zero=False):
    """Log-probs (U, T, 38) and per-row frames, labels (padded with −1)
    and label counts on the card; rows past ``n_real`` are padding rows
    (no frames, no labels)."""
    rng = np.random.default_rng(seed)
    n_real = u - 1 if n_real is None else n_real
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(u, t, 38)).astype(np.float32) * 2), -1)
    utt_len = np.zeros(u, np.int64)
    text_len = np.zeros(u, np.int64)
    labels = np.full((u, s), -1, np.int64)
    for i in range(n_real):
        utt_len[i] = rng.integers(t // 4, t + 1)
        text_len[i] = rng.integers(1, min(s, utt_len[i] // 3) + 1)
        labels[i, :text_len[i]] = rng.integers(0, 37, size=text_len[i])
    if repeat:
        labels[0, 1] = labels[0, 0]
    if last_zero:
        labels[1, text_len[1] - 1] = 0
    if infeasible:
        utt_len[2], text_len[2] = 4, 5
        labels[2] = -1
        labels[2, :5] = [1, 2, 3, 4, 5]
    return [lp.cuda()] + [torch.from_numpy(x).cuda()
                          for x in (utt_len, labels, text_len)]


def _ctc_run(fn, lp, utt_len, labels, text_len, weights):
    x = lp.detach().clone().requires_grad_()
    nll = fn(x, utt_len, labels, text_len, 37)
    (nll * weights).sum().backward()
    return nll.detach(), x.grad


CTC_CASES = {"plain": {}, "repeat_and_last_zero": dict(
    repeat=True, last_zero=True), "infeasible": dict(infeasible=True),
    # the recognition micro-step: 64 rows, 19 of them real, t_cap frames,
    # TEXT_CAP label positions
    "micro_step": dict(u=64, t=1024, s=128, n_real=19, infeasible=True)}


@pytest.mark.parametrize("case", list(CTC_CASES))
def test_ctc_kernel_matches_plain(card, case):
    args = _ctc_case(3, **CTC_CASES[case])
    weights = torch.rand(args[0].shape[0], device="cuda")
    before = (ctc_nll.launches, ctc_nll.backward_launches)
    nll, grad = _ctc_run(ctc_nll, *args, weights)
    torch.cuda.synchronize()
    assert (ctc_nll.launches - before[0],
            ctc_nll.backward_launches - before[1]) == (1, 1)
    ref, ref_grad = _ctc_run(ctc_nll_plain, *args, weights)
    assert torch.isfinite(nll).all()
    torch.testing.assert_close(nll, ref, rtol=CTC_NLL_RTOL, atol=0)
    tol = CTC_GRAD_RTOL * float(ref_grad.abs().max())
    torch.testing.assert_close(grad, ref_grad, rtol=0, atol=tol)
    utt_len, text_len = args[1], args[3]
    for i in range(len(utt_len)):   # exact zeros past a row's frames
        assert not grad[i, int(utt_len[i]):].any()
    assert not grad[text_len == 0].any()   # padding rows: no frames either


def test_ctc_kernel_is_bit_equal_between_calls(card):
    args = _ctc_case(4, **CTC_CASES["micro_step"])
    weights = torch.rand(args[0].shape[0], device="cuda")
    first = _ctc_run(ctc_nll, *args, weights)
    second = _ctc_run(ctc_nll, *args, weights)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def _ctc_rows(seed, t, s, rows):
    """Log-probs (U, T, 38) and one row per (label count, frame count) of
    ``rows``, labels in [0, 37), on the card."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(len(rows), t, 38)).astype(np.float32) * 2), -1)
    labels = np.full((len(rows), s), -1, np.int64)
    for i, (n_labels, _) in enumerate(rows):
        labels[i, :n_labels] = rng.integers(0, 37, size=n_labels)
    return [lp.cuda()] + [torch.tensor(x).cuda() for x in (
        [r[1] for r in rows], labels, [r[0] for r in rows])]


def _ctc_matches_plain_and_repeats(args):
    weights = torch.rand(args[0].shape[0], device="cuda")
    nll, grad = _ctc_run(ctc_nll, *args, weights)
    again = _ctc_run(ctc_nll, *args, weights)
    torch.cuda.synchronize()
    ref, ref_grad = _ctc_run(ctc_nll_plain, *args, weights)
    torch.testing.assert_close(nll, ref, rtol=CTC_NLL_RTOL, atol=0)
    # the gradient of every row against autograd through the plain lattice;
    # a row without labels (NLL −Σ_t lp[t, blank]) gets −weight at each
    # live frame's blank and 0 elsewhere
    tol = CTC_GRAD_RTOL * float(ref_grad.abs().max())
    torch.testing.assert_close(grad, ref_grad, rtol=0, atol=tol)
    assert torch.equal(nll, again[0]) and torch.equal(grad, again[1])
    utt_len, text_len = args[1], args[3]
    for i in range(len(utt_len)):   # exact zeros past a row's frames
        assert not grad[i, int(utt_len[i]):].any()
        if text_len[i] == 0:
            live = grad[i, :int(utt_len[i])]
            assert torch.equal(live[:, 37], -weights[i].expand(len(live)))
            assert not live[:, :37].any()
    torch.testing.assert_close(grad, ctc_grad_plain(*args, 37) * weights[
        :, None, None], rtol=0, atol=tol)


@pytest.mark.parametrize("frames", ["one", "chunk_less_one", "chunk",
                                    "chunk_plus_one", "all"])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_ctc_kernel_at_the_chunk_edges(card, which, frames):
    # the chunk of the forward (log-probs staged) or of the backward (step
    # coefficients), at S = 128 label positions; T is no multiple of it
    from silent_speech_tpu_torch.ops.ctc import chunk_frames

    f = chunk_frames(38, 128)[which == "backward"]
    t = 2 * f + 37
    n = {"one": 1, "chunk_less_one": f - 1, "chunk": f,
         "chunk_plus_one": f + 1, "all": t}[frames]
    # a feasible row, one with as many labels as frames allow, and an
    # infeasible one (more labels than frames)
    _ctc_matches_plain_and_repeats(_ctc_rows(
        6, t, 128, [(min(n // 3, 128), n), (min(n, 128), n),
                    (min(n + 2, 128), n)]))


@pytest.mark.parametrize("n_labels", [0, 31, 32, 33, 63, 64])
def test_ctc_kernel_at_the_warp_edges(card, n_labels):
    # positions 0..L over one warp (L = 31), two (32, 33, 63) and three (64)
    _ctc_matches_plain_and_repeats(_ctc_rows(
        7, 200, 64, [(n_labels, 200), (n_labels, 150), (1, 200)]))


def test_ctc_kernel_at_the_label_limit(card):
    # 1023 positions, the most a CTA holds, over a short utterance: the
    # ~1e5 loss of an infeasible target beside feasible rows
    _ctc_matches_plain_and_repeats(_ctc_rows(
        8, 40, MAX_LABELS, [(MAX_LABELS, 40), (1000, 33), (0, 40),
                            (13, 40)]))


@pytest.mark.parametrize("frames", [1, 37, 200])
def test_ctc_kernel_gradient_of_rows_without_labels(card, frames):
    # rows with frames and no labels, beside a row with labels: the
    # kernel's gradient against autograd through the plain lattice
    _ctc_matches_plain_and_repeats(_ctc_rows(
        11, 200, 32, [(0, frames), (12, 200), (0, 200), (0, 0)]))


def test_ctc_kernel_gives_nan_for_a_label_outside_the_classes(card):
    lp, utt_len, labels, text_len = _ctc_rows(9, 100, 16, [(10, 90),
                                                           (12, 100)])
    fixed = ctc_nll(lp, utt_len, labels, text_len, 37)
    labels[1, 3] = 40
    nll = ctc_nll(lp, utt_len, labels, text_len, 37)
    assert torch.isnan(nll[1]) and torch.equal(nll[0], fixed[0])


def test_ctc_kernel_rejects_rows_past_its_limit(card):
    lp, utt_len, _, text_len = _ctc_case(0)
    labels = torch.zeros((lp.shape[0], MAX_LABELS + 1), dtype=torch.int64,
                         device="cuda")
    with pytest.raises(ValueError, match="MAX_LABELS"):
        ctc_nll(lp, utt_len, labels, text_len, 37)


def test_recognition_micro_steps_are_bit_equal(card):
    # two micro-steps from the same state on the same batch, dropout and
    # shift drawn from the same seeds: equal losses and gradients
    batch = _tiny_recognizer("cpu")._pack(_recognition_examples())
    runs = []
    for _ in range(2):
        trainer = _tiny_recognizer("cuda")
        before = ctc_nll.launches
        loss = trainer.train_step(batch, 1e-3)
        torch.cuda.synchronize()
        assert ctc_nll.launches == before + 1
        runs.append((loss, {n: p.grad for n, p in
                            trainer.model.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    differ = [n for n, g in runs[0][1].items()
              if not torch.equal(g, runs[1][1][n])]
    assert not differ, differ


def _transduction_examples():
    rng = np.random.default_rng(5)
    out = []
    for i, (t, silent) in enumerate(((60, True), (45, True), (70, False))):
        ex = {"emg": np.zeros((t, 112), np.float32),
              "raw_emg": rng.normal(size=(8 * t, 8)).astype(np.float32),
              "session_ids": np.zeros(t, np.int64), "silent": silent,
              "text": "a b", "text_int": np.zeros(3, np.int64)}
        t_tgt = t + 7 if silent else t
        key = "parallel_voiced_audio_features" if silent \
            else "audio_features"
        ex[key] = rng.normal(size=(t_tgt, 80)).astype(np.float32)
        ex["phonemes"] = rng.integers(0, 48, size=t_tgt)
        out.append(ex)
    return out


def test_transduction_steps_are_bit_equal(card):
    # two steps from the same state on the same batch (silent rows, so the
    # DTW path's repeated frames), dropout and shift from the same seeds:
    # equal losses and gradients under cuDNN's deterministic algorithms
    batch = _tiny_trainer("cpu")._pack(_transduction_examples())
    assert batch.num_silent
    runs = []
    for _ in range(2):
        trainer = _tiny_trainer("cuda")
        out = trainer.train_step(batch, 1e-3)
        torch.cuda.synchronize()
        runs.append((out.loss, {n: p.grad for n, p in
                                trainer.model.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    differ = [n for n, g in runs[0][1].items()
              if not torch.equal(g, runs[1][1][n])]
    assert not differ, differ


TINY_VOCODER = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                    upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                    resblock_dilation_sizes=((1, 2),))


def test_gan_steps_are_bit_equal(card):
    from silent_speech_tpu_torch.dsp.mel import MelConfig
    from silent_speech_tpu_torch.models.hifigan import HiFiGANConfig
    from silent_speech_tpu_torch.train.vocoder import VocoderTrainer

    rng = np.random.default_rng(6)
    mels = (0.1 * rng.normal(size=(4, 32, 80))).astype(np.float32)
    audio = (0.3 * rng.normal(size=(4, 32 * 8))).astype(np.float32)
    runs = []
    for _ in range(2):
        trainer = VocoderTrainer(
            gen_cfg=HiFiGANConfig(**TINY_VOCODER),
            mel_cfg=MelConfig(n_fft=64, hop_size=8, win_size=64),
            disc_periods=(2, 3), disc_scales=2, disc_width_div=8,
            device="cuda")
        metrics = trainer.train_step(mels, audio, 1e-3)
        runs.append((metrics, {**trainer.generator.state_dict(),
                               **trainer.disc.state_dict()}))
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
    differ = [n for n, w in runs[0][1].items()
              if not torch.equal(w, runs[1][1][n])]
    assert not differ, differ


def test_generator_on_card_matches_cpu(card):
    from silent_speech_tpu_torch.models.hifigan import (HiFiGANConfig,
                                                        init_generator)

    gen = init_generator(HiFiGANConfig(), torch.Generator().manual_seed(0))
    mel = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 32, 80)).astype(np.float32))
    with torch.no_grad():
        ref = gen(mel)
        out = gen.to("cuda")(mel.to("cuda")).cpu()
    assert out.shape == (1, 32 * 256)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_log_mel_on_card_matches_cpu(card):
    from silent_speech_tpu_torch.dsp.mel import torch_log_mel_spectrogram

    audio = torch.from_numpy((0.3 * np.random.default_rng(8).normal(
        size=(2, 8192))).astype(np.float32))
    ref = torch_log_mel_spectrogram(audio)
    out = torch_log_mel_spectrogram(audio.to("cuda")).cpu()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


# -- the zero-phase filter chain (csrc/filtfilt.cu) --------------------------

def _ragged_emg(lengths, t_pad, seed=0):
    """(B, t_pad, 8) float32 of σ = 100, zero past each length."""
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), t_pad, 8), np.float32)
    for u, n in enumerate(lengths):
        x[u, :n] = rng.normal(size=(n, 8)) * 100
    return torch.from_numpy(x)


# 3·ntaps + 1 for the high-pass, lengths not a multiple of 32, the full pad
FILTER_LENGTHS = [13, 4096, 1000, 777, 2049, 31, 3333, 4095]


def test_filter_chain_kernel_is_bit_equal_to_plain(card):
    from silent_speech_tpu_torch.dsp.device_pipeline import filter_coeffs
    from silent_speech_tpu_torch.ops.filtfilt import (filtfilt_chain,
                                                      filtfilt_chain_plain)

    coeffs = filter_coeffs()
    x = _ragged_emg(FILTER_LENGTHS, 4096)
    lengths = torch.tensor(FILTER_LENGTHS)
    before = filtfilt_chain.launches
    out = filtfilt_chain(x.cuda(), lengths, coeffs)
    torch.cuda.synchronize()
    assert filtfilt_chain.launches == before + 1
    assert torch.equal(out.cpu(), filtfilt_chain_plain(x, lengths, coeffs))


def test_filter_chain_kernel_does_not_depend_on_the_grouping(card):
    from silent_speech_tpu_torch.dsp.device_pipeline import filter_coeffs
    from silent_speech_tpu_torch.ops.filtfilt import filtfilt_chain

    coeffs = filter_coeffs()
    x = _ragged_emg(FILTER_LENGTHS, 4096, seed=1).cuda()
    lengths = torch.tensor(FILTER_LENGTHS)
    whole = filtfilt_chain(x, lengths, coeffs)
    split = torch.cat([filtfilt_chain(x[:3], lengths[:3], coeffs),
                       filtfilt_chain(x[3:], lengths[3:], coeffs)])
    alone = filtfilt_chain(x[3:4, :777], lengths[3:4], coeffs)
    again = filtfilt_chain(x, lengths, coeffs)
    assert torch.equal(whole, split)
    assert torch.equal(whole[3, :777], alone[0])
    assert torch.equal(whole, again)


@pytest.mark.parametrize("taps", [2, 3, 4])
def test_filter_kernel_of_each_width_with_columns_across_ctas(card, taps):
    # one filter (its forward pass reads x, its reverse pass writes out),
    # C = 3 so that utterances straddle the CTAs of 32 columns
    from scipy.signal import butter

    from silent_speech_tpu_torch.ops.filtfilt import (filtfilt_chain,
                                                      filtfilt_chain_plain)

    b, a = butter(taps - 1, 0.1, btype="highpass")
    coeffs = ((b, a),)
    lengths = [3 * taps + 1, 300, 129, 64, 65, 3 * taps + 2, 250, 299, 31,
               200, 17 + 3 * taps, 128]
    rng = np.random.default_rng(taps)
    x = np.zeros((len(lengths), 300, 3), np.float32)
    for u, n in enumerate(lengths):
        x[u, :n] = rng.normal(size=(n, 3)) * 100
    x = torch.from_numpy(x)
    lengths = torch.tensor(lengths)
    out = filtfilt_chain(x.cuda(), lengths, coeffs)
    assert torch.equal(out.cpu(), filtfilt_chain_plain(x, lengths, coeffs))


@pytest.mark.parametrize("channels", [1, 4, 8, 12, 16, 32])
def test_filter_chain_kernel_on_each_route(card, channels):
    # the launcher's two ways of moving data: 4 channels a lane (C % 4 ==
    # 0; at C = 12 utterances straddle the CTAs of 32 columns) and a float
    # a lane (C = 1); ragged lengths over several tiles
    from silent_speech_tpu_torch.dsp.device_pipeline import filter_coeffs
    from silent_speech_tpu_torch.ops.filtfilt import (filtfilt_chain,
                                                      filtfilt_chain_plain)

    coeffs = filter_coeffs()
    lengths = [13, 700, 65, 400, 191, 97, 640, 699, 14]
    rng = np.random.default_rng(channels)
    x = np.zeros((len(lengths), 700, channels), np.float32)
    for u, n in enumerate(lengths):
        x[u, :n] = rng.normal(size=(n, channels)) * 100
    x = torch.from_numpy(x)
    lengths = torch.tensor(lengths)
    out = filtfilt_chain(x.cuda(), lengths, coeffs)
    assert torch.equal(out.cpu(), filtfilt_chain_plain(x, lengths, coeffs))


def test_filter_chain_kernel_at_a_corpus_group(card):
    # S-corpus: 512 utterances of 6,000..16,384 samples, one 256 MiB group
    # of a real corpus; the shortest and the longest utterance against the
    # plain version (exact, since a column never reads another), halves
    # launched apart against the whole, two calls
    from silent_speech_tpu_torch.ops.filtfilt import filtfilt_chain
    from silent_speech_tpu_torch.ops.filtfilt_study import (corpus_group,
                                                            sliced_check)

    x, lengths, coeffs = corpus_group(0)
    before = filtfilt_chain.launches
    whole = filtfilt_chain(x, lengths, coeffs)
    torch.cuda.synchronize()
    assert filtfilt_chain.launches == before + 1
    assert sliced_check(x, lengths, coeffs, whole)["equal"]
    half = len(lengths) // 2
    assert torch.equal(whole[:half], filtfilt_chain(x[:half], lengths[:half],
                                                    coeffs))
    assert torch.equal(whole[half:], filtfilt_chain(x[half:], lengths[half:],
                                                    coeffs))
    assert torch.equal(whole, filtfilt_chain(x, lengths, coeffs))


def test_a_cuda_tensor_never_reaches_the_plain_filter(card, monkeypatch):
    from silent_speech_tpu_torch.dsp import device_filters
    from silent_speech_tpu_torch.dsp.device_pipeline import (clean_emg,
                                                             filter_coeffs)
    from silent_speech_tpu_torch.ops import filtfilt as filtfilt_module

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain loop")

    for module, name in ((device_filters, "lfilter"),
                         (device_filters, "filtfilt_masked_plain"),
                         (device_filters, "filtfilt_plain"),
                         (filtfilt_module, "filtfilt_masked_plain"),
                         (filtfilt_module, "filtfilt_chain_plain")):
        monkeypatch.setattr(module, name, refuse)
    x = _ragged_emg([300], 300)[0].cuda()
    b, a = filter_coeffs()[0]
    before = filtfilt_module.filtfilt_chain.launches
    assert device_filters.filtfilt(b, a, x).shape == x.shape
    assert device_filters.filtfilt_masked(b, a, x, 200)[200:].abs().sum() \
        == 0
    assert clean_emg(x).shape == x.shape
    assert filtfilt_module.filtfilt_chain.launches == before + 3


def test_featurize_on_device_on_the_card_matches_the_cpu(card,
                                                         tmp_path):
    from silent_speech_tpu_torch.data.dataset import EMGDataset
    from silent_speech_tpu_torch.data.device_featurize import \
        featurize_on_device
    from silent_speech_tpu_torch.data.synthetic import generate_corpus
    from silent_speech_tpu_torch.ops.filtfilt import filtfilt_chain

    cfg = generate_corpus(str(tmp_path / "c"), n_voiced_sessions=1,
                          n_silent_sessions=1, utterances_per_session=4,
                          seed=21)
    data = EMGDataset(cfg, limit_length=True)
    before = filtfilt_chain.launches
    card_out = featurize_on_device(data, device="cuda")
    assert filtfilt_chain.launches == before + 1     # the whole corpus
    cpu_out = featurize_on_device(data, device="cpu")
    for i, (got, want) in enumerate(zip(card_out, cpu_out)):
        assert got["raw_emg"].shape == want["raw_emg"].shape
        # the filter is bit-equal; the interpolation, /20 and tanh round
        # in the last bits on the card (values within ±50)
        np.testing.assert_allclose(got["raw_emg"], want["raw_emg"], rtol=0,
                                   atol=1e-4)
        # the DFT products in another order (f32, TF32 off)
        np.testing.assert_allclose(got["audio_features"],
                                   want["audio_features"], rtol=0,
                                   atol=1e-3)
        host = data[i]
        # the host path's bounds (tests/test_jax_featurize.py:72-83)
        np.testing.assert_allclose(got["raw_emg"], host["raw_emg"], rtol=0,
                                   atol=5e-2)
        np.testing.assert_allclose(got["audio_features"],
                                   host["audio_features"], rtol=0,
                                   atol=2e-2)


def test_a_streaming_recompute_on_the_card_is_the_offline_predict(card):
    from silent_speech_tpu_torch.eval.decode import greedy_ctc_decode
    from silent_speech_tpu_torch.eval.streaming import (
        StreamingRecognizer, demo_trainer, featurize_raw_window)

    trainer = demo_trainer("", "cuda")
    stream = StreamingRecognizer(trainer, hop_s=0.5)
    x = np.random.default_rng(4).normal(size=(3000, 8)) * 30
    stream.feed(x)
    before = rel_attention.launches
    text = stream.transcript(force=True)
    assert rel_attention.launches == before + trainer.model_cfg.num_layers
    lp = trainer.predict_logits(featurize_raw_window(x))
    assert text == trainer.text_transform.int_to_text(
        greedy_ctc_decode(lp, trainer.blank_id))


def _int8_bundles(tmp_path, kind="transduction"):
    """An int8 bundle of a small random encoder (4 heads of 16 for the
    attention kernel) and the bf16 bundle of its dequantized weights."""
    from silent_speech_tpu_torch.eval import export

    cfg = ModelConfig(model_size=64, num_layers=2, num_heads=4,
                      dim_feedforward=128, relative_positional_distance=16)
    heads = (80, 48) if kind == "transduction" else (38, None)
    model = EMGEncoder(*heads, cfg).init_weights(
        torch.Generator().manual_seed(4))
    state = {k: v.detach() for k, v in model.state_dict().items()}
    export.save_serving_bundle(model, kind, str(tmp_path / "q"),
                               t_buckets=(64, 256), quantize="int8")
    twin = EMGEncoder.from_state_dict(
        export.dequantize_state(export.quantize_state(state)))
    export.save_serving_bundle(twin, kind, str(tmp_path / "twin"),
                               t_buckets=(64, 256))
    return [export.ServingBundle.load(str(tmp_path / d), device="cuda")
            for d in ("q", "twin")]


def test_int8_bundle_weights_stay_int8_on_the_card(card, tmp_path):
    bundle, _ = _int8_bundles(tmp_path)
    int8 = [p for n, p in bundle.model.named_parameters()
            if n.endswith(".original")]
    assert int8 and all(p.dtype == torch.int8 and p.is_cuda for p in int8)
    scales = [b for n, b in bundle.model.named_buffers()
              if n.endswith(".scale")]
    assert len(scales) == len(int8)
    assert all(s.dtype == torch.float32 and s.is_cuda for s in scales)


@pytest.mark.parametrize("kind", ["transduction", "recognition"])
def test_int8_bundle_equals_its_dequantized_twin_on_the_card(card, tmp_path,
                                                             kind):
    bundle, twin = _int8_bundles(tmp_path, kind)
    rng = np.random.default_rng(0)
    for t in (50, 200):
        emg = np.zeros((t, 112), np.float32)
        raw = rng.normal(size=(8 * t, 8)).astype(np.float32)
        before = rel_attention.launches
        out = bundle.predict(emg, raw, np.zeros(t, np.int64))
        assert rel_attention.launches == before + 2   # 2 layers
        ref = twin.predict(emg, raw, np.zeros(t, np.int64))
        assert np.isfinite(out).all()
        assert torch.equal(torch.from_numpy(out), torch.from_numpy(ref))


def test_trace_records_the_card_s_kernels(card, tmp_path):
    import json

    from silent_speech_tpu_torch.utils.profiling import trace

    q, k, v, e = _inputs(256, torch.bfloat16)
    with trace(str(tmp_path)):
        rel_attention(q, k, v, e, 100, 256)
        torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(ev.get("cat") == "kernel" and "fwd_kernel" in ev.get("name", "")
               for ev in events)


def _step_examples():
    # five utterances in the dataset's schema, two of them silent
    rng = np.random.default_rng(0)
    out = []
    for t, silent in ((55, True), (40, False), (71, True), (33, False),
                      (28, False)):
        tt = t + 7 if silent else t
        ex = {"emg": rng.normal(size=(t, 112)).astype(np.float32),
              "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
              "session_ids": np.zeros(t, np.int64), "silent": silent,
              "text": "a test",
              "text_int": rng.integers(0, 37, size=12).astype(np.int64),
              "phonemes": rng.integers(0, 48, size=tt).astype(np.int64)}
        key = "parallel_voiced_audio_features" if silent \
            else "audio_features"
        ex[key] = rng.normal(size=(tt, 80)).astype(np.float32)
        out.append(ex)
    return out


def test_trace_places_a_step_s_kernels_in_the_program_s_spans(card,
                                                              tmp_path):
    # one transduction step at small widths, dropout on, under trace():
    # every launch falls inside ssp.step's time, the backward's on
    # autograd's thread while the stepping thread is in ssp.backward, the
    # dropout masks' inside ssp.dropout.mask on the thread that draws them
    # (both threads); no span is drawn on the device
    import json

    from silent_speech_tpu_torch.config import (DataConfig,
                                                TransductionTrainConfig)
    from silent_speech_tpu_torch.data.device_cache import DeviceCorpus
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer
    from silent_speech_tpu_torch.utils.profiling import trace

    cfg = ModelConfig(model_size=64, num_layers=2, num_heads=2,
                      dim_feedforward=128, relative_positional_distance=16,
                      compute_dtype="float32", dropout=0.2)
    trainer = TransductionTrainer(
        cfg, DataConfig(seq_len=64, chunk_bucket=4, utt_cap=8, t_cap=128),
        TransductionTrainConfig(max_batch_len=4000), device="cuda")
    trainer.init_state(0)
    corpus = DeviceCorpus.build(_step_examples(), "cuda")
    assert trainer.train_step_ids(corpus, [4, 0, 3, 2], 1e-3) is not None
    torch.cuda.synchronize()
    with trace(str(tmp_path)):
        trainer.train_step_ids(corpus, [1, 2, 0], 1e-3)
        torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "cpu_op" \
                and ev["name"].startswith("ssp."):
            spans.setdefault(ev["name"], []).append(
                (ev["tid"], ev["ts"], ev["ts"] + ev["dur"]))
    launch = {ev["args"]["correlation"]: (ev["tid"], ev["ts"])
              for ev in events if ev.get("cat") == "cuda_runtime"
              and "correlation" in ev.get("args", {})}
    kernels = [launch[ev["args"]["correlation"]] for ev in events
               if ev.get("cat") == "kernel"
               and ev.get("args", {}).get("correlation") in launch]
    assert kernels
    assert not [ev for ev in events if ev.get("cat") == "gpu_user_annotation"
                and ev["name"].startswith("ssp.")]
    (step,) = spans["ssp.step"]
    stepping = step[0]

    def launched_in(name, any_thread):
        return [(tid, t) for tid, t in kernels
                if any(s <= t <= e and (tid == own or any_thread)
                       for own, s, e in spans[name]
                       if own == stepping or not any_thread)]

    assert len(launched_in("ssp.step", True)) == len(kernels)
    # the backward's seed gradient fills on the stepping thread, the rest
    # launches on autograd's
    assert {tid for tid, _ in launched_in("ssp.backward", True)} - {stepping}
    masks = {tid for tid, _ in launched_in("ssp.dropout.mask", False)}
    assert stepping in masks and masks - {stepping}


@pytest.mark.parametrize("kind", ["transduction", "recognition"])
def test_a_float32_step_convolves_in_full_fp32(card, monkeypatch, kind):
    # cuDNN's TF32 allowed outside, as torch's default has it: inside a
    # float32 step every convolution agrees with float64 to float32's
    # rounding; the same convolutions outside the step, TF32 on, part by
    # far more (where cuDNN picks a TF32 kernel: at least one does)
    from silent_speech_tpu_torch.config import (DataConfig,
                                                RecognitionTrainConfig,
                                                TransductionTrainConfig)
    from silent_speech_tpu_torch.data.device_cache import DeviceCorpus
    from silent_speech_tpu_torch.models import encoder
    from silent_speech_tpu_torch.train.recognition import RecognitionTrainer
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen, conv = [], encoder._conv

    def recording(module, x, dtype):
        out = conv(module, x, dtype)
        seen.append((x.detach().clone(), module.weight.detach().clone(),
                     module.bias.detach().clone(), module.stride,
                     module.padding, out.detach().clone()))
        return out

    monkeypatch.setattr(encoder, "_conv", recording)
    cfg = ModelConfig(model_size=256, num_layers=1, num_heads=2,
                      dim_feedforward=256, relative_positional_distance=16,
                      compute_dtype="float32", dropout=0.2)
    data = DataConfig(seq_len=64, chunk_bucket=4, utt_cap=8, t_cap=128)
    if kind == "transduction":
        trainer = TransductionTrainer(
            cfg, data, TransductionTrainConfig(max_batch_len=4000),
            device="cuda")
    else:
        trainer = RecognitionTrainer(
            cfg, data, RecognitionTrainConfig(max_batch_len=4000),
            device="cuda")
    trainer.init_state(0)
    corpus = DeviceCorpus.build(_step_examples(), "cuda")
    assert trainer.train_step_ids(corpus, [4, 0, 3, 2], 1e-3) is not None
    torch.cuda.synchronize()
    assert len(seen) == 9 and torch.backends.cudnn.allow_tf32

    def gap(x, w, b, stride, padding, out):
        ref = torch.nn.functional.conv1d(x.double(), w.double(), b.double(),
                                         stride, padding)
        return float((out.double() - ref).norm() / ref.norm())

    step_gaps = [gap(*rec) for rec in seen]
    tf32_gaps = [gap(*rec[:5], torch.nn.functional.conv1d(
        rec[0], rec[1], rec[2], rec[3], rec[4])) for rec in seen]
    assert max(step_gaps) < 1e-5, step_gaps
    assert max(tf32_gaps) > 1e-4, tf32_gaps


# ---- the dropout-cell offsets of K1f and K1b, and the mesh -------------
SHARD = dict(b_offset=3, h_offset=4, h_total=12)


@pytest.mark.parametrize("dtype,atol,rel", [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 1e-2)])
def test_rel_attention_with_offsets_matches_plain(card, dtype, atol, rel):
    # rows 3.. and heads 4.. of a batch of 12 heads, with dropout: the
    # forward against the plain version with the same cells, the backward
    # against autograd through it
    q, k, v, e = _inputs(200, dtype, seed=9, h=4, b=2)
    dout = torch.randn_like(q.float()).to(dtype)
    out = rel_attention(q, k, v, e, 100, 150, 5, DROP, **SHARD)
    ref = rel_attention_plain(
        q, k, v, e, 100, 150, 5, DROP,
        store_dtype=dtype if dtype == torch.bfloat16 else None, **SHARD)
    assert (out.float() - ref.float()).abs().max().item() <= atol
    grads = rel_attention_bwd(q, k, v, e, dout, 100, 150, 5, DROP, **SHARD)
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v, e)]
    rel_attention_plain(*leaves, 100, 150, 5, DROP, **SHARD).backward(
        dout.float())
    for got, p in zip(grads, leaves):
        err = (got.float() - p.grad).abs().max() / p.grad.abs().max()
        assert err.item() <= rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_attention_shard_is_the_slice_of_the_whole(card, dtype):
    # each (row, head) cell is computed alone: a shard with its offsets
    # gives the whole batch's outputs and dQ, dK, dV bit for bit
    q, k, v, e = _inputs(200, dtype, seed=3, h=12, b=5)
    dout = torch.randn_like(q.float()).to(dtype)
    rows, heads = slice(3, 5), slice(4, 8)
    part = [x[rows, heads].contiguous() for x in (q, k, v, dout)]
    es = e[heads].contiguous()
    out = rel_attention(*part[:3], es, 100, 200, 7, DROP, **SHARD)
    whole = rel_attention(q, k, v, e, 100, 200, 7, DROP)
    assert torch.equal(out, whole[rows, heads])
    grads = rel_attention_bwd(*part[:3], es, part[3], 100, 200, 7, DROP,
                              **SHARD)
    grads_whole = rel_attention_bwd(q, k, v, e, dout, 100, 200, 7, DROP)
    for got, want in zip(grads[:3], grads_whole[:3]):
        assert torch.equal(got, want[rows, heads])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_attention_default_cells_are_today_s(card, dtype):
    # the defaults (0, 0, H) draw the masks of a call without offsets
    q, k, v, e = _inputs(200, dtype, seed=4, h=8, b=3)
    dout = torch.randn_like(q.float()).to(dtype)
    cells = dict(b_offset=0, h_offset=0, h_total=8)
    assert torch.equal(rel_attention(q, k, v, e, 100, 200, 2, DROP),
                       rel_attention(q, k, v, e, 100, 200, 2, DROP, **cells))
    for a, b in zip(rel_attention_bwd(q, k, v, e, dout, 100, 200, 2, DROP),
                    rel_attention_bwd(q, k, v, e, dout, 100, 200, 2, DROP,
                                      **cells)):
        assert torch.equal(a, b)


def test_mesh_step_on_one_card_is_the_plain_step(card):
    # a 1x1 mesh over a real NCCL process group: the step equals the plain
    # trainer's bit for bit, collectives and all
    from silent_speech_tpu_torch.parallel.collectives import calls
    from silent_speech_tpu_torch.parallel.mesh import destroy, make_mesh
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer

    cfg = ModelConfig(model_size=64, num_layers=2, num_heads=2,
                      dim_feedforward=128, relative_positional_distance=16,
                      compute_dtype="bfloat16")
    try:
        mesh = make_mesh(1, 1, "cuda")
        plain = TransductionTrainer(cfg, device="cuda")
        meshed = TransductionTrainer(cfg, mesh=mesh)
        plain.init_state(0)
        meshed.init_state(0)
        batch = plain._pack(_transduction_examples())
        calls.count = 0
        before = _batch_norm_launches()
        out_m = meshed.train_step(batch, 1e-3)
        assert calls.count > 0
        mesh_bn = tuple(a - b for a, b in zip(_batch_norm_launches(), before))
        before = _batch_norm_launches()
        out_p = plain.train_step(batch, 1e-3)
        plain_bn = tuple(a - b for a, b in zip(_batch_norm_launches(),
                                               before))
        # the BatchNorm kernels on both; the mesh sums the statistics over
        # its data axis between two finalizes
        assert (mesh_bn, plain_bn) == ((6, 18, 6, 6, 6), (6, 12, 6, 6, 6))
        assert torch.equal(out_m.loss, out_p.loss)
        for a, b in zip(meshed.model.parameters(), plain.model.parameters()):
            assert torch.equal(a.grad, b.grad)
            assert torch.equal(a, b)
    finally:
        destroy()


def test_mesh_asks_a_card_a_rank(card):
    from silent_speech_tpu_torch.graft_entry import dryrun_multichip

    with pytest.raises(RuntimeError, match="cards"):
        dryrun_multichip(torch.cuda.device_count() + 1, "cuda")


# ---- the counter-hash dropout (ops/dropout.py, csrc/dropout.cu) ----------
DROP8 = dropout_threshold(0.2)
DROPOUT_OPS = {"regen": regen_dropout, "relu": relu_dropout}


def _drop_input(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to("cuda", dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _dropout_launches():
    return mask_scale.launches, relu_dropout.backward_launches


def _dropout_run(op, x, g, seed, shard=None):
    """The forward and the input gradient of ``op`` on ``x`` through
    autograd, the cotangent ``g``."""
    xi = x.detach().clone().requires_grad_()
    y = DROPOUT_OPS[op](xi, seed, DROP8, shard)
    y.backward(g)
    return y.detach(), xi.grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op", ["regen", "relu"])
@pytest.mark.parametrize("shape,shard", [
    ((120, 200, 768), None),            # the training step's norm sites
    ((120, 200, 3072), None),           # and its FFN
    ((3, 7, 13), None),                 # an odd count, width not of 8
    ((5, 100), None),
    ((3, 13), Shard(1)),                # base % 4 == 1, 2, 3
    ((3, 13), Shard(2)),
    ((3, 13), Shard(3)),
    ((2, 50, 768), Shard(4, 768, 3072)),  # a model rank's FFN columns
    ((4, 100), Shard(5, 37, 301)),      # groups across a row's end
    ((3, 13), Shard(2 ** 31 + 1)),      # hash words past 2^32
], ids=["w768", "w3072", "odd", "w100", "base1", "base2", "base3", "ffn",
        "cols", "words64"])
def test_dropout_kernels_match_plain_and_repeat(card, dtype, op, shape,
                                                shard):
    # the forward and the gradient torch.equal to the plain path, and bit
    # for bit the same in two calls
    x, g = _drop_input(shape, dtype, 1), _drop_input(shape, dtype, 2)
    before = _dropout_launches()
    runs = [_dropout_run(op, x, g, 77, shard) for _ in range(2)]
    torch.cuda.synchronize()
    masks, relu_bwd = (a - b for a, b in zip(_dropout_launches(), before))
    assert (masks, relu_bwd) == ((4, 0) if op == "regen" else (2, 2))
    want_y = mask_scale_plain(x, 77, DROP8, shard, relu=op == "relu")
    want_g = (mask_scale_plain(g, 77, DROP8, shard) if op == "regen"
              else relu_dropout_backward_plain(g, want_y, DROP8))
    for y, grad in runs:
        assert torch.equal(y, want_y)
        assert torch.equal(grad, want_g)
    assert torch.equal(_bits(runs[0][0]), _bits(runs[1][0]))
    assert torch.equal(_bits(runs[0][1]), _bits(runs[1][1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_kernels_on_unaligned_buffers(card, dtype):
    # contiguous views 2 or 4 bytes past a 16-byte boundary take the
    # kernels' element-by-element loads and stores
    shape = (7, 33)
    n = 7 * 33
    x = _drop_input((n + 1,), dtype, 3)[1:].view(shape)
    g = _drop_input((n + 1,), dtype, 4)[1:].view(shape)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    y = mask_scale(x, 5, DROP8, Shard(3), relu=True)
    assert torch.equal(y, mask_scale_plain(x, 5, DROP8, Shard(3), relu=True))
    y_off = torch.cat([y.new_zeros(1), y.reshape(-1)])[1:].view(shape)
    assert y_off.data_ptr() % 16
    assert torch.equal(_launch_relu_bwd(g, y_off, DROP8),
                       relu_dropout_backward_plain(g, y, DROP8))


@pytest.mark.parametrize("op", ["regen", "relu"])
def test_dropout_at_threshold_0_launches_nothing(card, op):
    x = _drop_input((4, 64), torch.bfloat16, 5).requires_grad_()
    before = _dropout_launches()
    y = DROPOUT_OPS[op](x, 3, 0)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    assert _dropout_launches() == before
    assert torch.equal(y, x if op == "regen" else torch.relu(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op", ["regen", "relu"])
def test_dropout_ops_do_not_sync_the_stream(card, op, dtype):
    x = _drop_input((64, 768), dtype, 6)
    g = _drop_input((64, 768), dtype, 7)
    _dropout_run(op, x, g, 9)       # builds and loads the kernels
    torch.cuda.synchronize()
    before = _dropout_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, grad = _dropout_run(op, x, g, 9, Shard(2))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _dropout_launches() != before
    assert torch.equal(y, mask_scale_plain(x, 9, DROP8, Shard(2),
                                           relu=op == "relu"))


def test_dropout_rejects_what_the_kernels_do_not_take(card):
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        mask_scale(torch.zeros(4, 8, device="cuda", dtype=torch.float16), 1,
                   DROP8)
    with pytest.raises(ValueError, match="contiguous"):
        mask_scale(torch.zeros(8, 4, device="cuda").t(), 1, DROP8)


def test_a_transduction_micro_step_launches_36_dropout_kernels(card):
    # 6 layers, each: the residual masks of norm1 and norm2 forward and
    # regenerated backward (4), the FFN's ReLU dropout forward (1) and
    # its backward (1)
    from silent_speech_tpu_torch.config import (DataConfig,
                                                TransductionTrainConfig)
    from silent_speech_tpu_torch.data.device_cache import DeviceCorpus
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer

    cfg = ModelConfig(model_size=64, num_layers=6, num_heads=2,
                      dim_feedforward=128, relative_positional_distance=16,
                      dropout=0.2)
    trainer = TransductionTrainer(
        cfg, DataConfig(seq_len=64, chunk_bucket=4, utt_cap=8, t_cap=128),
        TransductionTrainConfig(max_batch_len=4000), device="cuda")
    trainer.init_state(0)
    corpus = DeviceCorpus.build(_step_examples(), "cuda")
    assert trainer.train_step_ids(corpus, [4, 0, 3, 2], 1e-3) is not None
    torch.cuda.synchronize()
    before = _dropout_launches()
    assert trainer.train_step_ids(corpus, [1, 2, 0], 1e-3) is not None
    torch.cuda.synchronize()
    masks, relu_bwd = (a - b for a, b in zip(_dropout_launches(), before))
    assert (masks, relu_bwd) == (30, 6)


# ---- AdamW in one launch (ops/adamw.py, csrc/adamw.cu) ---------------------
class _LoopAdamW(FusedAdamW):
    """The per-leaf loop on any device: the kernels' oracle."""

    def _leaves(self):
        return None


def _adamw_pair(shapes, moment_dtype, weight_decay, grad_accum, views=False):
    """The same leaves twice on the card, under the kernels and under the
    loop; ``views``: each leaf a view 4 bytes past a 16-byte boundary."""
    g = torch.Generator().manual_seed(11)
    start = [torch.randn(s, generator=g) for s in shapes]
    pairs = []
    for cls in (FusedAdamW, _LoopAdamW):
        leaves = [(_unaligned(x) if views else x.to("cuda")) for x in start]
        params = [torch.nn.Parameter(x) for x in leaves]
        pairs.append((params, cls(params, weight_decay=weight_decay,
                                  moment_dtype=moment_dtype,
                                  grad_accum=grad_accum)))
    return pairs


def _unaligned(x):
    flat = torch.empty(x.numel() + 1, device="cuda")
    out = flat[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16
    return out


def _adamw_run(pairs, micro_steps, missing=(), views=False):
    """``micro_steps`` micro-steps at a new rate each, gradients at three
    scales; leaf k of ``missing`` has no ``.grad``, leaf 1 none at
    micro-step 1. Returns the counters' launches."""
    g = torch.Generator().manual_seed(12)
    before = adamw.adamw_update.launches, adamw.adamw_fold.launches
    for step in range(micro_steps):
        grads = [torch.randn(p.shape, generator=g) * 10.0 ** -(step % 3)
                 for p in pairs[0][0]]
        lr = 1e-3 * (1 + 0.37 * step)
        emitted = []
        for params, opt in pairs:
            for k, (p, x) in enumerate(zip(params, grads)):
                gone = k in missing or (k == 1 and step == 1)
                p.grad = None if gone else (_unaligned(x) if views
                                            else x.to("cuda"))
            emitted.append(opt.step(lr))
        assert emitted[0] == emitted[1]
    torch.cuda.synchronize()
    return (adamw.adamw_update.launches - before[0],
            adamw.adamw_fold.launches - before[1])


def _assert_adamw_equal(pairs):
    (p1, o1), (p2, o2) = pairs
    assert o1._on_card is not None and o2._on_card is None
    assert (o1.count, o1.mini_step) == (o2.count, o2.mini_step)
    for name, xs, ys in (("p", p1, p2), ("m", o1.mu, o2.mu),
                         ("v", o1.nu, o2.nu), ("acc", o1.acc, o2.acc)):
        for k, (x, y) in enumerate(zip(xs, ys)):
            assert torch.equal(x, y), f"{name} of leaf {k}"


RAGGED = [(1,), (0,), (3,), (48,), (80,), (1027,), (768, 3072)]


@pytest.mark.parametrize("grad_accum", [1, 2, 3])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-7])
@pytest.mark.parametrize("moment_dtype", [torch.bfloat16, torch.float32])
def test_adamw_kernels_match_the_loop_bit_for_bit(card, moment_dtype,
                                                  weight_decay, grad_accum):
    # three groups and a part, leaf 2 never with a gradient, leaf 1 empty
    pairs = _adamw_pair(RAGGED, moment_dtype, weight_decay, grad_accum)
    micro_steps = 3 * grad_accum + 1
    updates, folds = _adamw_run(pairs, micro_steps, missing=(2,))
    assert (updates, folds) == (micro_steps // grad_accum,
                                micro_steps if grad_accum > 1 else 0)
    _assert_adamw_equal(pairs)
    assert pairs[0][1].count == micro_steps // grad_accum


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("moment_dtype", [torch.bfloat16, torch.float32])
def test_adamw_kernels_on_the_transduction_model_s_leaves(card, moment_dtype,
                                                          grad_accum):
    shapes = [tuple(p.shape) for p in EMGEncoder(80, 48, ModelConfig())
              .parameters()]
    assert len(shapes) == 120
    pairs = _adamw_pair(shapes, moment_dtype, 1e-7, grad_accum)
    updates, folds = _adamw_run(pairs, 2 * grad_accum)
    assert (updates, folds) == (2, 4 if grad_accum > 1 else 0)
    _assert_adamw_equal(pairs)


@pytest.mark.parametrize("moment_dtype", [torch.bfloat16, torch.float32])
def test_adamw_kernels_on_unaligned_leaves_and_gradients(card, moment_dtype):
    pairs = _adamw_pair([(1,), (3,), (48,), (80,), (1027,), (7, 33)],
                        moment_dtype, 1e-7, 2, views=True)
    assert all(p.data_ptr() % 16 for p in pairs[0][0])
    _adamw_run(pairs, 5, views=True)
    _assert_adamw_equal(pairs)


def test_adamw_past_one_launch_s_leaves(card):
    n = adamw.leaves_per_launch() + 20
    pairs = _adamw_pair([(1 + k % 37,) for k in range(n)], torch.bfloat16,
                        1e-7, 2)
    updates, folds = _adamw_run(pairs, 4, missing=(0, n - 1))
    assert (updates, folds) == (2 * 2, 4 * 2)    # two launches each
    _assert_adamw_equal(pairs)


def test_adamw_does_not_sync_the_stream(card):
    pairs = _adamw_pair(RAGGED, torch.bfloat16, 1e-7, 2)
    params, opt = pairs[0]
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step(1e-3)                  # builds the table and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert opt.step(1e-3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert not any(a.any() for a in opt.acc)


def test_adamw_rejects_what_the_kernels_do_not_take(card):
    def step(p, grad=None):
        p.grad = torch.ones_like(p) if grad is None else grad
        FusedAdamW([p]).step(1e-3)

    with pytest.raises(ValueError, match="float32 parameters"):
        step(torch.nn.Parameter(torch.zeros(8, device="cuda",
                                            dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="contiguous leaves"):
        step(torch.nn.Parameter(torch.zeros(8, 4, device="cuda").t()))
    with pytest.raises(ValueError, match="contiguous float32 gradients"):
        step(torch.nn.Parameter(torch.zeros(8, 4, device="cuda")),
             torch.zeros(4, 8, device="cuda").t())


def test_recognition_micro_steps_fold_each_and_update_every_second(card):
    batch = _tiny_recognizer("cpu")._pack(_recognition_examples())
    trainer = _tiny_recognizer("cuda")
    before = adamw.adamw_update.launches, adamw.adamw_fold.launches
    for _ in range(3):
        trainer.train_step(batch, 1e-3)
    torch.cuda.synchronize()
    assert (adamw.adamw_update.launches - before[0],
            adamw.adamw_fold.launches - before[1]) == (1, 3)
    assert (trainer.optimizer.count, trainer.optimizer.mini_step) == (1, 1)


# ---- the conv stack's BatchNorm (ops/batch_norm.py, csrc/batchnorm.cu) -----

# the fused passes against the plain composition (batch_norm_plain and
# autograd) on the card, both float32 inside: sums in another order, mean
# and E[x²] as sums over n, the apply as one fma, the backward's formula
# in place of autograd's chain. An element whose pre-activation lies within
# rounding of 0 takes the other side of the ReLU in the two (about one in
# 3e7 on an H100): its own output and input gradient move by O(1), its
# channel's Σg by its g. So outputs and input gradients are compared by
# relative L2 error (a flip costs ~3e-4 of a 120x768x200 tensor's norm;
# measured on an H100 at 700 W: 8.9e-8 to 4.6e-4 in f32, 1.9e-5 to 2.4e-4
# in bf16), parameter gradients channel by channel against the sum of their
# terms' magnitudes, Σ|g| and Σ|g·x̂| (a flip moves a channel by one term,
# ~6e-5 of it; measured up to 1.8e-5), and running statistics by the
# largest error over the largest entry (no ReLU; measured 2.6e-7).
BN_L2 = 3e-3
BN_SUM_RTOL = 5e-4
BN_RUNNING_RTOL = 2e-5
BN_MODES = ("bn_relu", "bn_bn_add_relu", "bn_input_add_relu")


def _bn_module(c, seed):
    g = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm1d(c, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.normal_(0.0, 0.3, generator=g)
        bn.running_mean.normal_(0.0, 1.0, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    return bn.cuda()


def _bn_inputs(mode, shape, dtype, seed=0, constant_channel=None):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def conv_out():
        x = torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.2
        if constant_channel is not None:
            x[:, constant_channel] = 0.5
        return x.to(dtype)

    xs, bns, res = [conv_out()], [_bn_module(shape[1], seed + 1)], None
    if mode == "bn_bn_add_relu":
        xs.append(conv_out())
        bns.append(_bn_module(shape[1], seed + 2))
    elif mode == "bn_input_add_relu":
        res = torch.randn(shape, device="cuda", generator=g).to(dtype)
    grads = [torch.randn(shape, device="cuda", generator=g).to(dtype)
             for _ in range(2)]
    return xs, bns, res, grads


def _bn_run(mode, xs, bns, res, grads, fused, forks=1):
    """Output (in the compute dtype), input gradients, parameter gradients
    and running statistics of one forward and backward; with ``forks=2``
    the output's two consumers hand back ``grads``' two gradients."""
    import copy

    from silent_speech_tpu_torch.ops.batch_norm import (
        bn_add_relu, bn_add_relu_plain, bn_relu, bn_relu_plain)

    xs = [x.clone().requires_grad_() for x in xs]
    res = None if res is None else res.clone().requires_grad_()
    bns = [copy.deepcopy(bn) for bn in bns]
    dtype = xs[0].dtype
    if mode == "bn_relu":
        outs = (bn_relu(xs[0], bns[0], True) if fused
                else bn_relu_plain(xs[0], bns[0], True))
    else:
        other = xs[1] if mode == "bn_bn_add_relu" else res
        res_bn = bns[1] if mode == "bn_bn_add_relu" else None
        outs = (bn_add_relu(xs[0], bns[0], other, res_bn, True, forks=forks)
                if fused else
                bn_add_relu_plain(xs[0], bns[0], other, res_bn, True))
    # every consumer reads the compute dtype; the plain output's two
    # consumers each cast it, so their gradients meet in float32
    if not fused:
        outs = tuple(outs.to(dtype) for _ in range(forks))
    elif forks == 1:
        outs = (outs,)
    torch.autograd.backward(outs, grads[:forks])
    dxs = [x.grad for x in xs] + ([] if res is None else [res.grad])
    params = [t for bn in bns for t in (bn.weight.grad, bn.bias.grad)]
    running = [t for bn in bns for t in (bn.running_mean, bn.running_var)]
    return outs[0].detach(), dxs, params, running


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _bn_matches_plain(mode, shape, dtype, forks=1, **kw):
    from silent_speech_tpu_torch.ops.batch_norm import statistics_plain

    xs, bns, res, grads = _bn_inputs(mode, shape, dtype, **kw)
    got = _bn_run(mode, xs, bns, res, grads, True, forks)
    want = _bn_run(mode, xs, bns, res, grads, False, forks)
    for a, b in zip([got[0]] + got[1], [want[0]] + want[1]):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert _rel_l2(a, b) <= BN_L2
    # each channel's Σ|g| and Σ|g·x̂|, the scale of dβ and dγ
    g = sum(t.float() for t in grads[:forks])
    stats = statistics_plain(xs, bns)
    c = shape[1]
    for i, x in enumerate(xs):
        mean, rstd = stats[0, i * c:(i + 1) * c], stats[1, i * c:(i + 1) * c]
        xhat = (x.float() - mean[:, None]) * rstd[:, None]
        dw, db = got[2][2 * i: 2 * i + 2]
        ref_dw, ref_db = want[2][2 * i: 2 * i + 2]
        assert ((dw - ref_dw).abs()
                <= BN_SUM_RTOL * (g * xhat).abs().sum((0, 2))).all()
        assert ((db - ref_db).abs() <= BN_SUM_RTOL * g.abs().sum((0, 2))).all()
    for a, b in zip(got[3], want[3]):
        assert float((a - b).abs().max() / b.abs().max()) <= BN_RUNNING_RTOL
    return got, want


@pytest.mark.parametrize("b", [120, 64])
@pytest.mark.parametrize("length", [800, 400, 200])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", BN_MODES[:2])
def test_batch_norm_kernels_match_the_plain_composition(card, mode, dtype,
                                                        length, b):
    # the conv stack's shapes: C = 768, L = 800 / 400 / 200 by block
    _bn_matches_plain(mode, (b, 768, length), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", BN_MODES)
def test_batch_norm_kernels_at_an_odd_length(card, mode, dtype):
    # L = 37 is no whole number of 16-byte groups: element-wise loads, the
    # last group of each row partial
    _bn_matches_plain(mode, (6, 40, 37), dtype)


@pytest.mark.parametrize("length", [200, 37])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", BN_MODES[1:])
def test_batch_norm_kernels_add_a_forked_output_s_two_gradients(
        card, mode, dtype, length):
    # a block's end feeds the next block's conv1 and residual path: two
    # handles on one output, two gradients, added in float32 as the plain
    # output's two casts add them
    _bn_matches_plain(mode, (16, 96, length), dtype, forks=2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_batch_norm_kernels_at_a_constant_channel(card, dtype):
    # channel 3 holds one value, 0.5, whose sums are exact in any order:
    # E[x²] − E[x]² is 0 in both, rstd 1/√ε, x̂ 0, and the channel's output
    # one value (relu(β2 + β_res)). A channel whose difference rounds below
    # 0 clips to this; its gradient's rule is held in float64 on the CPU
    # (tests/test_torch_batch_norm.py), as the sign of such a rounding
    # depends on the order of the sums
    got, _ = _bn_matches_plain("bn_bn_add_relu", (16, 64, 200), dtype,
                               constant_channel=3)
    out = got[0][:, 3].float()
    assert (out - out[0, 0]).abs().max() <= 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", BN_MODES)
def test_batch_norm_kernels_are_bit_equal_between_calls(card, mode, dtype):
    xs, bns, res, grads = _bn_inputs(mode, (120, 768, 200), dtype)
    forks = 1 if mode == "bn_relu" else 2
    first = _bn_run(mode, xs, bns, res, grads, True, forks)
    second = _bn_run(mode, xs, bns, res, grads, True, forks)
    for a, b in zip([first[0]] + first[1] + first[2] + first[3],
                    [second[0]] + second[1] + second[2] + second[3]):
        assert torch.equal(a, b)


def test_batch_norm_rejects_what_the_kernels_do_not_take(card):
    from silent_speech_tpu_torch.ops.batch_norm import bn_relu

    bn = _bn_module(8, 0)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        bn_relu(torch.zeros(2, 8, 16, device="cuda", dtype=torch.float16),
                bn, True)
    with pytest.raises(ValueError, match="float32 parameters"):
        bn_relu(torch.zeros(2, 8, 16, device="cuda"), _bn_module(8, 0).half(),
                True)


def _batch_norm_launches():
    from silent_speech_tpu_torch.ops import batch_norm as bn

    return tuple(f.launches for f in (
        bn.batch_norm_stats, bn.batch_norm_finalize, bn.batch_norm_apply,
        bn.batch_norm_bwd_reduce, bn.batch_norm_bwd_apply))


def test_a_micro_step_of_each_trainer_launches_36_batch_norm_kernels(card):
    # three ResBlocks, each two fused BNs: a statistics pass, a finalize and
    # an apply forward, a reduction, a finalize and an apply backward; the
    # eval forward launches none
    examples = {"transduction": _transduction_examples(),
                "recognition": _recognition_examples()}
    for kind, trainer in (("transduction", _tiny_trainer("cuda")),
                          ("recognition", _tiny_recognizer("cuda"))):
        batch = trainer._pack(examples[kind])
        trainer.train_step(batch, 1e-3)
        torch.cuda.synchronize()
        before = _batch_norm_launches()
        trainer.train_step(batch, 1e-3)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(_batch_norm_launches(), before))
        assert counts == (6, 12, 6, 6, 6), (kind, counts)
        before = _batch_norm_launches()
        with torch.no_grad():
            trainer.model(torch.as_tensor(batch.raw_emg[:2]).cuda())
        torch.cuda.synchronize()
        assert _batch_norm_launches() == before, kind


def test_a_bf16_conv_stack_saves_no_float32_activation(card):
    # what autograd keeps of the three ResBlocks' training forward: the
    # compute-dtype conv outputs and inputs, weights and per-channel
    # statistics, no float32 tensor the size of a channel's activations
    cfg = ModelConfig(model_size=768, num_layers=1, num_heads=8,
                      dim_feedforward=256, relative_positional_distance=16)
    model = EMGEncoder(80, 48, cfg).init_weights(
        torch.Generator().manual_seed(0)).cuda()
    raw = torch.randn(8, 1600, 8, device="cuda")
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h = raw.transpose(1, 2)
        for i, block in enumerate(model.conv_blocks):
            h = block(h, True, 1 if i == 2 else 2)
    assert h.dtype == torch.bfloat16
    smallest = 8 * 768 * 200  # the last block's (B, C, L)
    big_f32 = [n for dtype, n in saved
               if dtype == torch.float32 and n >= smallest]
    assert not big_f32, big_f32
