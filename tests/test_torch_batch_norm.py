"""The conv stack's fused BatchNorm on the CPU (``ops/batch_norm.py``): the
kernels' steps in plain tensor code (the statistics, the apply pass, the
backward's sums and its apply from the saved compute-dtype tensors) held
in float64 to autograd through ``batch_norm_plain``, the clipped-variance
case included; the sums of two data ranks' shares give the one-process
backward, as the mesh's all-reduce does; CPU tensors keep the plain
composition and count no launch; and the wrappers' checks and geometry.
The kernels themselves are held to the plain composition on the card
(``tests/test_torch_kernels_cuda.py``)."""

import copy

import pytest
import torch
from torch import nn

from silent_speech_tpu_torch.ops import batch_norm as bn_ops
from silent_speech_tpu_torch.ops.batch_norm import (
    BN_MOMENTUM, SLAB_ELEMENTS, _slabs, _vec, backward_apply_plain,
    backward_plain, backward_reduce_plain, batch_norm_plain, bn_add_relu,
    bn_relu, forward_plain, statistics_plain)

MODES = ("bn_relu", "bn_bn_add_relu", "bn_input_add_relu")
# float64 throughout: the two sides differ in rounding alone
RTOL, ATOL = 1e-9, 1e-11


def _bn(c, seed):
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm1d(c, eps=1e-5).double()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g, dtype=torch.float64) + 0.5)
        bn.bias.normal_(0.0, 0.3, generator=g)
        bn.running_mean.normal_(0.0, 1.0, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    return bn


def _clip(t, channel):
    """Set ``channel`` of t to values about a large mean with a spread of
    1e-3 whose E[x²] − E[x]², formed as ``batch_norm_plain`` forms it,
    rounds below 0 in float64: the first such mean of a few (which one
    depends on the summation order of ``mean``)."""
    b, _, length = t.shape
    spread = 1e-3 * torch.randn(b, length, dtype=torch.float64,
                                generator=torch.Generator().manual_seed(0))
    for mean in (1e8, 3e8, 1e9, 3e9, 1e10):
        t[:, channel] = mean + spread
        m = t.mean((0, 2))
        if ((t * t).mean((0, 2)) - m * m)[channel] < 0:
            return t
    raise AssertionError("no clipped channel among the candidates")


def _case(mode, shape, seed=0, clipped_channel=None):
    """Inputs, BNs and the upstream gradient of one mode, float64."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]

    def x():
        t = torch.randn(shape, generator=g, dtype=torch.float64) * 2 + 0.3
        return t if clipped_channel is None else _clip(t, clipped_channel)

    xs = [x()]
    bns = [_bn(c, seed + 1)]
    r = None
    if mode == "bn_bn_add_relu":
        xs.append(x())
        bns.append(_bn(c, seed + 2))
    elif mode == "bn_input_add_relu":
        r = torch.randn(shape, generator=g, dtype=torch.float64)
    grad = torch.randn(shape, generator=g, dtype=torch.float64)
    return xs, bns, r, grad


def _autograd(xs, bns, r, grad):
    """Output, running statistics and every gradient through the plain
    composition."""
    xs = [x.clone().requires_grad_() for x in xs]
    r = None if r is None else r.clone().requires_grad_()
    bns = [copy.deepcopy(bn) for bn in bns]
    pre = sum(batch_norm_plain(bn, x, True) for bn, x in zip(bns, xs))
    out = torch.relu(pre if r is None else pre + r)
    out.backward(grad)
    params = []
    for bn in bns:
        params += [bn.bias.grad, bn.weight.grad]
    return (out.detach(), [x.grad for x in xs],
            None if r is None else r.grad, params,
            [(bn.running_mean, bn.running_var) for bn in bns])


@pytest.mark.parametrize("shape", [(4, 3, 40), (3, 5, 37), (2, 4, 1)],
                         ids=["L40", "L37-odd", "L1"])
@pytest.mark.parametrize("mode", MODES)
def test_the_staged_backward_is_autograd_through_the_plain_composition(
        mode, shape):
    xs, bns, r, grad = _case(mode, shape)
    out, dxs, dr, params, _ = _autograd(xs, bns, r, grad)
    stats = statistics_plain(xs, bns)
    b, _, length = shape
    torch.testing.assert_close(forward_plain(xs, r, stats), out,
                               rtol=RTOL, atol=ATOL)
    got_dxs, got_dr, got_params = backward_plain(grad, xs, r, stats,
                                                 b * length)
    for got, want in zip(got_dxs + got_params, dxs + params):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if r is None:
        assert got_dr is None
    else:
        torch.testing.assert_close(got_dr, dr, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_a_clipped_channel_drops_the_variance_term_as_autograd_does(mode):
    xs, bns, r, grad = _case(mode, (4, 3, 37), clipped_channel=1)
    stats = statistics_plain(xs, bns)
    unclipped = stats[4].reshape(len(xs), 3)
    assert unclipped[:, 1].eq(0).all() and unclipped[:, [0, 2]].eq(1).all()
    _, dxs, dr, params, _ = _autograd(xs, bns, r, grad)
    got_dxs, got_dr, got_params = backward_plain(grad, xs, r, stats, 4 * 37)
    for got, want in zip(got_dxs, dxs):
        # the clipped channel's x̂ is of order 1 (rstd = 1/√ε over a
        # spread of 1e-3), so the dropped term matters there
        torch.testing.assert_close(got, want, rtol=1e-7, atol=1e-7)
    for got, want in zip(got_params, params):
        torch.testing.assert_close(got, want, rtol=1e-7, atol=1e-7)
    # with the term kept, the clipped channel's gradient parts from it
    kept = stats.clone()
    kept[4] = 1.0
    wrong = backward_plain(grad, xs, r, kept, 4 * 37)[0][0]
    assert not torch.allclose(wrong[:, 1], dxs[0][:, 1], rtol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_two_data_ranks_sums_give_the_one_process_backward(mode):
    # a mesh's data ranks each hold half the rows; the statistics and the
    # backward's sums add over them before the apply steps
    xs, bns, r, grad = _case(mode, (6, 4, 24), seed=3)
    stats = statistics_plain(xs, bns)
    whole, whole_dr, _ = backward_plain(grad, xs, r, stats, 6 * 24)
    halves = [slice(0, 3), slice(3, 6)]

    def part(t, h):
        return None if t is None else t[h]

    tot = sum(backward_reduce_plain(grad[h], [x[h] for x in xs], part(r, h),
                                    stats) for h in halves)
    for i, h in enumerate(halves):
        dxs, dr = backward_apply_plain(grad[h], [x[h] for x in xs],
                                       part(r, h), stats, tot, 6 * 24)
        for got, want in zip(dxs, whole):
            torch.testing.assert_close(got, want[h], rtol=RTOL, atol=ATOL)
        if r is not None:
            torch.testing.assert_close(dr, whole_dr[h], rtol=RTOL, atol=ATOL)


def test_the_statistics_leave_the_running_ones_alone():
    xs, bns, _, _ = _case("bn_relu", (3, 4, 16))
    before = [bns[0].running_mean.clone(), bns[0].running_var.clone()]
    statistics_plain(xs, bns)
    assert torch.equal(bns[0].running_mean, before[0])
    assert torch.equal(bns[0].running_var, before[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
def test_cpu_tensors_keep_the_plain_composition_and_launch_nothing(dtype,
                                                                   residual):
    g = torch.Generator().manual_seed(5)
    c, res = (torch.randn(3, 4, 20, generator=g).to(dtype) for _ in range(2))
    bns = [nn.BatchNorm1d(4, eps=1e-5) for _ in range(3)]
    twins = copy.deepcopy(bns)
    counters = (bn_ops.batch_norm_stats, bn_ops.batch_norm_finalize,
                bn_ops.batch_norm_apply, bn_ops.batch_norm_bwd_reduce,
                bn_ops.batch_norm_bwd_apply)
    before = [f.launches for f in counters]
    h = bn_relu(c, bns[0], True, None, dtype)
    want_h = torch.relu(batch_norm_plain(twins[0], c, True))
    assert torch.equal(h, want_h) and h.dtype == torch.float32
    out = bn_add_relu(c, bns[1], res, bns[2] if residual else None, True,
                      None, dtype)
    want = batch_norm_plain(twins[1], c, True)
    want = torch.relu(want + (batch_norm_plain(twins[2], res, True)
                              if residual else res))
    assert torch.equal(out, want)
    for bn, twin in zip(bns, twins):
        assert torch.equal(bn.running_mean, twin.running_mean)
        assert torch.equal(bn.running_var, twin.running_var)
    assert [f.launches for f in counters] == before


def test_eval_takes_the_running_statistics_on_any_device():
    bn = _bn(4, 7).float()
    c = torch.randn(2, 4, 9)
    want = torch.relu(nn.functional.batch_norm(
        c, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
        bn.eps))
    assert torch.equal(bn_relu(c, bn, False), want)


@pytest.mark.parametrize("fn", ["bn_relu", "bn_add_relu"])
def test_a_non_cpu_tensor_takes_the_kernels_and_never_the_plain_path(fn):
    # a tensor off the CPU is the kernels' (a CUDA one launches them): here
    # a meta tensor, which they refuse by name rather than fall back
    bn = nn.BatchNorm1d(4).to("meta")
    c = torch.zeros(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no batch-norm kernel for device "
                                         "meta"):
        if fn == "bn_relu":
            bn_relu(c, bn, True)
        else:
            bn_add_relu(c, bn, c, bn, True)


@pytest.mark.parametrize("b,length", [(120, 800), (120, 400), (120, 200),
                                      (64, 200), (3, 20000), (1, 1), (7, 37)])
def test_slabs_cover_the_batch_rows_once(b, length):
    rows, p = _slabs(b, length)
    assert 1 <= rows <= b and (p - 1) * rows < b <= p * rows
    assert rows * length <= max(SLAB_ELEMENTS, length)


def test_vector_loads_need_whole_groups_and_aligned_buffers():
    x = torch.zeros(2, 3, 16, dtype=torch.bfloat16)
    assert _vec(16, torch.bfloat16, x) == 1
    assert _vec(12, torch.bfloat16, x) == 0          # 12 % 8
    assert _vec(12, torch.float32, x.float()) == 1   # 12 % 4
    assert _vec(16, torch.bfloat16, x.view(-1)[1:]) == 0  # 2-byte offset


class _PlainLaunches:
    """The kernels' launches in plain tensor code on the CPU (one slab),
    so that the autograd function around them runs here: what each launch
    takes and returns, the running statistics moved as the finalize
    moves them."""

    def __init__(self, monkeypatch):
        self.reduced = 0
        for name in ("stats", "finalize", "apply", "bwd_reduce",
                     "bwd_finalize", "bwd_apply"):
            monkeypatch.setattr(bn_ops, f"batch_norm_{name}",
                                getattr(self, name))
        monkeypatch.setattr(bn_ops, "all_reduce_", self.all_reduce_)

    def all_reduce_(self, t, group):
        self.reduced += 1     # one data rank: the sum is the tensor
        return t

    @staticmethod
    def stats(xs):
        sums = [torch.stack([x.sum((0, 2)), (x * x).sum((0, 2))])
                for x in xs]
        return torch.cat(sums, 1)[None]

    @staticmethod
    def finalize(part, c, bns, count, sums_only=False):
        s = part.sum(0)
        if sums_only:
            return s
        mean, d = s[0] / count, s[1] / count - (s[0] / count) ** 2
        var = d.clamp_min(0.0)
        rstd = torch.rsqrt(var + bns[0].eps)
        w = torch.cat([bn.weight.detach() for bn in bns])
        b = torch.cat([bn.bias.detach() for bn in bns])
        for i, bn in enumerate(bns):
            m = BN_MOMENTUM
            bn.running_mean.mul_(m).add_((1 - m) * mean[i * c:(i + 1) * c])
            bn.running_var.mul_(m).add_((1 - m) * var[i * c:(i + 1) * c])
        return torch.stack([mean, rstd, rstd * w, b - mean * rstd * w,
                            (d >= 0).to(d.dtype)])

    @staticmethod
    def apply(xs, r, stats, store):
        return forward_plain(xs, r, stats).to(store)

    @staticmethod
    def bwd_reduce(gs, xs, r, stats):
        return backward_reduce_plain(sum(gs), xs, r, stats)[None]

    @staticmethod
    def bwd_finalize(part):
        tot = part.sum(0)
        grads = []
        for j in range(1, tot.shape[0]):
            grads += [tot[0].clone(), tot[j].clone()]
        return tot, grads

    @staticmethod
    def bwd_apply(gs, xs, r, stats, tot, count):
        dxs, dr = backward_apply_plain(sum(gs), xs, r, stats, tot, count)
        return ([d.to(x.dtype) for d, x in zip(dxs, xs)],
                None if dr is None else dr.to(r.dtype))


class _OneRankMesh:
    data_group, data_parallel = object(), 1


@pytest.mark.parametrize("mode,mesh,forks", [
    (mode, mesh, 1) for mode in MODES for mesh in (False, True)] + [
    (mode, False, 2) for mode in MODES[1:]])
def test_the_autograd_function_hands_each_gradient_to_its_input(
        monkeypatch, mode, mesh, forks):
    # the function around the kernels, its launches in plain code: output,
    # running statistics and every gradient as autograd through the plain
    # composition gives them; on a mesh, one sum over the data axis
    # forward and one backward; forked (a block's end), two handles on the
    # output whose gradients the backward adds
    launches = _PlainLaunches(monkeypatch)
    xs, bns, r, grad = _case(mode, (3, 4, 24), seed=4)
    grad2 = torch.randn(grad.shape, dtype=grad.dtype,
                        generator=torch.Generator().manual_seed(9))
    total = grad + grad2 if forks == 2 else grad
    out, dxs, dr, params, running = _autograd(xs, bns, r, total)
    leaves = [x.clone().requires_grad_() for x in xs]
    r_leaf = None if r is None else r.clone().requires_grad_()
    mods = [copy.deepcopy(bn) for bn in bns]
    args = ([leaves[0], mods[0].weight, mods[0].bias]
            + ([leaves[1], mods[1].weight, mods[1].bias] if len(xs) > 1
               else [r_leaf, None, None])
            + [mods[0], mods[1] if len(xs) > 1 else None,
               _OneRankMesh() if mesh else None, torch.float64, forks])
    got = bn_ops._FusedBatchNorm.apply(*args)
    if forks == 2:
        assert got[0].data_ptr() == got[1].data_ptr()
        torch.autograd.backward(got, [grad, grad2])
        got = got[0]
    else:
        got.backward(grad)
    assert launches.reduced == (2 if mesh else 0)
    torch.testing.assert_close(got, out, rtol=RTOL, atol=ATOL)
    for leaf, want in zip(leaves, dxs):
        torch.testing.assert_close(leaf.grad, want, rtol=RTOL, atol=ATOL)
    if r is not None:
        torch.testing.assert_close(r_leaf.grad, dr, rtol=RTOL, atol=ATOL)
    got_params = [t for bn in mods for t in (bn.bias.grad, bn.weight.grad)]
    for a, b in zip(got_params, params):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for bn, (mean, var) in zip(mods, running):
        torch.testing.assert_close(bn.running_mean, mean, rtol=RTOL,
                                   atol=ATOL)
        torch.testing.assert_close(bn.running_var, var, rtol=RTOL, atol=ATOL)
