"""The port's trainers on data × model meshes of gloo processes (2×2, 4×1
and 1×2) against one process, float32 at the tiny geometry: the
transduction step at dropout 0 and 0.2 (the shards draw the one-process
masks, so both hold), the recognition micro-steps with accumulation of 2,
checkpoints restored across topologies, and a serving bundle exported
from the sharded trainer. A 1×1 mesh (one gloo process, every collective
issued) is ``torch.equal`` to the plain trainer. The GAN step on meshes
is in ``test_torch_mesh_gan.py``.

The 2×2 and 4×1 meshes share one world of four processes, the 1×2 mesh
has one of two (``torch_mesh_workers.mesh_suites``), and the tests read
their results. Tolerances: the loss within 2e-4 relative; each gradient
within 1e-3 of its tensor's largest entry, except two kinds of entries
whose one-process value is rounding noise: the biases of the convs that
feed a BatchNorm (their exact gradient is 0; held to 1e-6), and, at
dropout 0.2, the rows of ``linear1`` of an FFN unit whose one-process
pre-activation lies within 1e-5 of 0, where the ReLU's side can flip with
the rounding of the synced BatchNorm statistics (measured: unit 81 of
layer 0 at 7e-7 gave 1.8e-3 on 2×2 and 4×1; at most four such units a
layer are allowed).
"""

import contextlib

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.eval.export import (ServingBundle,
                                                 save_serving_bundle)
from silent_speech_tpu_torch.models import transformer
from silent_speech_tpu_torch.parallel import launch
from silent_speech_tpu_torch.parallel.mesh import destroy, make_mesh

import torch_mesh_workers as workers
from torch_port_util import one_torch_thread

MESHES = [(2, 2), (4, 1), (1, 2)]
IDS = [f"{dp}x{mp}" for dp, mp in MESHES]
LOSS_RTOL, GRAD_RTOL, REC_RTOL = 2e-4, 1e-3, 1e-3
NOISE_GRAD = ("conv1.bias", "conv2.bias", "residual_path.bias")
NOISE_ATOL = 1e-6
RELU_EDGE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    out = {}
    for world in ([(2, 2), (4, 1)], [(1, 2)]):
        n = world[0][0] * world[0][1]
        out.update(launch.spawn(
            workers.mesh_suites, n,
            (world, str(tmp_path_factory.mktemp("mesh"))), threads=1)[0])
    return out


@contextlib.contextmanager
def _ffn_inputs(sink):
    """Record each FFN's pre-activation (the input of relu_dropout)."""
    fn = transformer.relu_dropout

    def spy(x, *args):
        sink.append(x.detach().clone())
        return fn(x, *args)

    transformer.relu_dropout = spy
    try:
        yield
    finally:
        transformer.relu_dropout = fn


@pytest.fixture(scope="module")
def one_process():
    exs = workers.examples()
    out = {}
    for dropout in (0.0, 0.2):
        pre = []
        with _ffn_inputs(pre):
            out[("step", dropout)] = workers.transduction_step(
                workers.transduction_trainer(None, dropout), exs)
        out[("pre", dropout)] = pre
    out["recognition"] = workers.recognition_steps(
        workers.recognition_trainer(None), exs)
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_transduction_loss_matches_one_process(suites, one_process, mesh,
                                               dropout):
    got, _ = suites[mesh][("step", dropout)]
    want, _ = one_process[("step", dropout)]
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def _edge_units(pre, layer):
    x = pre[layer].reshape(-1, pre[layer].shape[-1]).abs()
    return torch.nonzero(x.min(0).values < RELU_EDGE).flatten()


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_transduction_gradients_match_one_process(suites, one_process, mesh,
                                                  dropout):
    _, got = suites[mesh][("step", dropout)]
    _, want = one_process[("step", dropout)]
    pre = one_process[("pre", dropout)]
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if name.endswith(NOISE_GRAD):
            assert (g - w).abs().max() <= NOISE_ATOL, name
            continue
        keep = torch.ones_like(w, dtype=torch.bool)
        if dropout and ".linear1." in name:
            units = _edge_units(pre, int(name.split(".")[2]))
            assert len(units) <= 4, (name, units)
            keep[units] = False
        err = ((g - w).abs() * keep).max()
        assert err <= GRAD_RTOL * w.abs().max(), (name, float(err))


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_recognition_micro_steps_match_one_process(suites, one_process,
                                                   mesh):
    got, state = suites[mesh]["recognition"]
    want, want_state = one_process["recognition"]
    np.testing.assert_allclose(got, want, rtol=REC_RTOL)
    # the weights moved once, at the second micro-step (the third loss
    # saw them): Adam's first step moves each weight by about ±LR, the
    # sign of its gradient, which rounding decides where the gradient is
    # noise, so the states agree to 2·LR
    for k, v in want_state.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                   atol=2 * workers.LR, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_checkpoint_restores_across_topologies(suites, mesh):
    res = suites[mesh]
    extra, exact_nx1, loss_nx1 = res["restore_nx1"]
    exact_11, loss_11 = res["restore_1x1"]
    assert extra == {"epoch": 1}
    assert exact_nx1 and exact_11
    for loss in (loss_nx1, loss_11):
        assert abs(loss - res["restore_src"]) <= 1e-3 * abs(
            res["restore_src"])


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_export_from_the_sharded_trainer_is_the_one_process_bundle(
        suites, mesh, tmp_path):
    one = workers.transduction_trainer()
    one.init_state(0)
    save_serving_bundle(one.model, "transduction", str(tmp_path))
    ex = workers.examples()[1]
    sess = np.zeros(ex["emg"].shape[0], np.int32)
    outs = [ServingBundle.load(d, device="cpu", dtype=torch.float32).predict(
                ex["emg"], ex["raw_emg"], sess)
            for d in (suites[mesh]["bundle_dir"], str(tmp_path))]
    np.testing.assert_array_equal(*outs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_one_by_one_mesh_step_is_the_plain_step(dtype):
    from silent_speech_tpu_torch.config import DataConfig, \
        TransductionTrainConfig
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer

    cfg = workers.model_config(dropout=0.2, shift=True)
    cfg.compute_dtype = dtype

    def trainer(mesh):
        t = TransductionTrainer(cfg, DataConfig(**workers.DATA),
                                TransductionTrainConfig(max_batch_len=8000),
                                device="cpu", mesh=mesh)
        t.init_state(0)
        return t

    try:
        meshed, plain = trainer(make_mesh(1, 1, "cpu")), trainer(None)
        batch = plain._pack(workers.examples())
        for _ in range(2):
            a = meshed.train_step(batch, 1e-3)
            b = plain.train_step(batch, 1e-3)
            assert torch.equal(a.loss, b.loss)
        for (name, p), q in zip(meshed.model.named_parameters(),
                                plain.model.parameters()):
            assert torch.equal(p.grad, q.grad), name
            assert torch.equal(p, q), name
    finally:
        destroy()
