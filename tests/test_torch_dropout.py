"""The counter-hash dropout's wrapper on the CPU (``ops/dropout.py``): CPU
tensors take the plain versions without counting a launch, the kernels'
checks, and the index arguments the wrapper hands ``csrc/dropout.cu``,
held to ``keep_mask`` under a Python rendering of the kernel's rule (16
bytes a thread: 8 bf16 or 4 f32 elements, each hash word once, the run
shifted by its start's byte, element by element across a row's end of a
column shard). The kernel itself is held to the plain versions on the card
(``tests/test_torch_kernels_cuda.py``)."""

import pytest
import torch

from silent_speech_tpu_torch.ops import dropout
from silent_speech_tpu_torch.ops.dropout import (
    M32, Shard, _check, _geometry, dropout_threshold, hash_bits, keep_mask,
    mask_scale, mask_scale_plain, regen_dropout, relu_dropout,
    relu_dropout_backward_plain)

T8 = dropout_threshold(0.2)


def _hash(word: int, seed: int) -> int:
    return int(hash_bits(torch.tensor(word), 0, seed))


def _kernel_keep(shape, seed, threshold, shard, v):
    """keep of every element as the kernel draws it, group by group of
    ``v`` elements, from the wrapper's arguments."""
    n, width, base, row0, col0, cols = _geometry(shape, shard)
    whole = col0 == 0 and cols == width
    keep = []
    for i0 in range(0, n, v):
        r, c = divmod(i0, width)
        if whole or c + v <= width:
            g0 = base + i0 if whole else (row0 + r) * cols + col0 + c
            w0, sh = (g0 >> 2) & M32, 8 * (g0 & 3)
            h = [_hash((w0 + k) & M32, seed) for k in range(v // 4)]
            h.append(_hash((w0 + v // 4) & M32, seed) if sh else 0)
            b = [(((h[k + 1] << 32) | h[k]) >> sh) & M32
                 for k in range(v // 4)]
            bytes_ = [(b[j // 4] >> (8 * (j % 4))) & 0xFF for j in range(v)]
        else:
            bytes_ = []
            for _ in range(v):
                if c == width:
                    c, r = 0, r + 1
                g = (row0 + r) * cols + col0 + c
                bytes_.append((_hash((g >> 2) & M32, seed) >> (8 * (g & 3)))
                              & 0xFF)
                c += 1
        keep += [b >= threshold for b in bytes_]
    return torch.tensor(keep[:n]).reshape(shape)


@pytest.mark.parametrize("v", [8, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,shard", [
    ((3, 5, 16), None),                   # whole rows, base 0
    ((4, 13), None),                      # odd count, width not of 8
    ((3, 13), Shard(1)),                  # base % 4 == 1
    ((2, 3, 13), Shard(2)),               # base % 4 == 2
    ((3, 13), Shard(3)),                  # base % 4 == 3
    ((5, 100), Shard(7)),                 # width 100, base 700
    ((2, 3, 100), Shard(5, 37, 301)),     # columns 37..137 of 301
    ((4, 24), Shard(2, 24, 96)),          # an FFN shard, rank 1 of 4
    ((3, 13), Shard(2 ** 31 + 1)),        # hash words past 2³²
    ((2, 9), Shard(2 ** 31, 5, 17)),
], ids=["whole", "odd", "base1", "base2", "base3", "w100", "cols", "ffn",
        "words64", "cols64"])
def test_kernel_index_rule_draws_keep_mask(shape, shard, v):
    want = keep_mask(shape, 11, T8, "cpu", shard)
    assert torch.equal(_kernel_keep(shape, 11, T8, shard, v), want)


@pytest.mark.parametrize("shape,shard,args", [
    ((4, 5, 6), None, (120, 6, 0, 0, 0, 6)),
    ((4, 5, 6), Shard(10), (120, 6, 60, 10, 0, 6)),
    ((4, 5, 6), Shard(3, 12, 48), (120, 6, 144, 3, 12, 48)),
    ((), None, (1, 1, 0, 0, 0, 1)),
    ((0, 7), Shard(2), (0, 7, 14, 2, 0, 7)),
])
def test_geometry_gives_the_kernel_its_index_arguments(shape, shard, args):
    assert _geometry(shape, shard) == args


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["regen", "relu"])
def test_cpu_tensors_take_the_plain_version_without_counting(op, dtype):
    mask_scale.launches = relu_dropout.backward_launches = 0
    x = _inputs((3, 7, 40), dtype).requires_grad_()
    g = _inputs(x.shape, dtype, seed=1)
    shard = Shard(5)
    if op == "regen":
        y = regen_dropout(x, 9, T8, shard)
        want = mask_scale_plain(x.detach(), 9, T8, shard)
    else:
        y = relu_dropout(x, 9, T8, shard)
        want = mask_scale_plain(x.detach(), 9, T8, shard, relu=True)
    y.backward(g)
    grad = (mask_scale_plain(g, 9, T8, shard) if op == "regen"
            else relu_dropout_backward_plain(g, want, T8))
    assert torch.equal(y.detach(), want)
    assert torch.equal(x.grad, grad)
    assert mask_scale.launches == relu_dropout.backward_launches == 0


@pytest.mark.parametrize("make,match", [
    (lambda: [torch.zeros(4, 8, dtype=torch.float16)], "bfloat16 or"),
    (lambda: [torch.zeros(4, 8, dtype=torch.float64)], "bfloat16 or"),
    (lambda: [torch.zeros(8, 4).t()], "contiguous"),
    (lambda: [torch.zeros(4, 8), torch.zeros(4, 8, dtype=torch.bfloat16)],
     "beside"),
    (lambda: [torch.zeros(4, 8), torch.zeros(4, 9)], "beside"),
], ids=["float16", "float64", "strided", "dtypes", "shapes"])
def test_the_wrapper_rejects_what_the_kernels_do_not_take(make, match):
    with pytest.raises(ValueError, match=match):
        _check(*make())


def test_a_tensor_on_another_device_raises():
    with pytest.raises(ValueError, match="no mask_scale for device meta"):
        mask_scale(torch.zeros(4, 8, device="meta"), 1, T8)


def test_the_scale_passed_by_value_is_the_plain_version_s():
    # the kernel multiplies by the Python float of the scale rounded to
    # the dtype, which is the plain version's 0-dim tensor
    for dtype in dropout.KERNEL_DTYPES:
        plain = dropout._scale(T8, dtype)
        assert torch.tensor(dropout._scale_value(T8, dtype),
                            dtype=dtype) == plain
        assert float(plain) == dropout._scale_value(T8, dtype)
    assert dropout._scale_value(T8, torch.bfloat16) == 1.25
