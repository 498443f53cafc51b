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
from silent_speech_tpu_torch.ops.rel_attention import (
    rel_attention, rel_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # f32 references in full f32, not TF32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _inputs(t, dtype, seed=0, h=8, dh=96, m=100):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(1, h, t, dh, generator=g) for _ in range(3))
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
