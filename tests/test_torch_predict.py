"""The port's ``pad_single``, ``predict`` and ``get_aligned_prediction``
against the JAX trainer's, at the tiny geometry in float32 from the same
converted weights. The alignment is compared on the same prediction (the
JAX method given the port's), so that the DTW is the only difference:
JAX's scan and the Pallas kernel in interpret mode are the oracles. In its
own file: the JAX trainer switches the process to the ``rbg`` PRNG."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from silent_speech_tpu.config import Config
from silent_speech_tpu.data.normalizers import \
    FeatureNormalizer as JaxNormalizer
from silent_speech_tpu.ops.pallas.dtw_kernel import pallas_dtw_align_batch
from silent_speech_tpu.parallel.mesh import make_mesh
from silent_speech_tpu.train.transduction import \
    TransductionTrainer as JaxTrainer
from silent_speech_tpu_torch.data.normalizers import FeatureNormalizer
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

from torch_port_util import (example_dict, jax_encoder,
                             jax_prng_impl_restored, one_torch_thread,
                             random_variables, tiny_config)

# a padded f32 forward, XLA's segment mask vs the port's length mask: the
# serving tests' tolerance (test_torch_serving.py)
PREDICT_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def prng_impl_restored_and_one_torch_thread():
    with jax_prng_impl_restored(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def trainers():
    variables = random_variables(jax_encoder(80, 48), seed=4)
    cfg = Config()
    m = cfg.model
    m.model_size, m.num_layers, m.num_heads = 64, 2, 2
    m.dim_feedforward, m.relative_positional_distance = 128, 16
    m.dropout, m.compute_dtype = 0.0, "float32"
    jt = JaxTrainer(cfg, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    ex = example_dict(np.random.default_rng(0), 40, False)
    jt.init_state(jt._pack([ex]), seed=0)
    jt.state = jt.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    ours = TransductionTrainer(tiny_config(), device="cpu")
    ours.init_state(0)
    ours.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    return ours, jt


def _normalizers():
    rng = np.random.default_rng(9)
    means = rng.normal(size=(1, 80)).astype(np.float32)
    out = []
    for cls in (FeatureNormalizer, JaxNormalizer):
        n = cls()
        n.feature_means, n.feature_stddevs = means, np.float32(1.7)
        out.append(n)
    return out


@pytest.mark.parametrize("t", [5, 77, 96])
def test_pad_single_matches_jax(t):
    ex = example_dict(np.random.default_rng(t), t, False)
    raw, n = TransductionTrainer.pad_single(ex)
    ref = JaxTrainer.pad_single(ex)
    assert n == ref[-1] == t
    np.testing.assert_array_equal(raw, ref[1])


@pytest.mark.parametrize("t", [23, 77])
def test_predict_matches_jax(trainers, t):
    ours, jt = trainers
    ex = example_dict(np.random.default_rng(t), t, True, t_tgt=t + 6)
    out = ours.predict(ex)
    assert out.shape == (t, 80)
    np.testing.assert_allclose(out, jt.predict(ex), rtol=0,
                               atol=PREDICT_ATOL)


@pytest.mark.parametrize("t,t_tgt,silent", [(77, 83, True), (61, 52, True),
                                            (40, 40, False)])
def test_aligned_prediction_matches_jax(trainers, monkeypatch, t, t_tgt,
                                        silent):
    ours, jt = trainers
    ex = example_dict(np.random.default_rng(t), t, silent, t_tgt=t_tgt)
    norm, jax_norm = _normalizers()
    out = ours.get_aligned_prediction(ex, norm)
    pred = ours.predict(ex)
    monkeypatch.setattr(jt, "predict", lambda example: pred)
    ref = jt.get_aligned_prediction(ex, jax_norm)
    assert out.shape == ((t_tgt if silent else t), 80)
    np.testing.assert_array_equal(out, ref)   # the same rows, gathered
    if silent:  # the Pallas kernel on the same costs picks the same rows
        y = ex["parallel_voiced_audio_features"]
        costs = np.sqrt(np.clip((pred ** 2).sum(-1)[:, None]
                                + (y ** 2).sum(-1)[None, :]
                                - 2 * pred @ y.T, 1e-12, None))
        align, _ = pallas_dtw_align_batch(
            jnp.asarray(costs.T[None]), jnp.asarray([t_tgt], jnp.int32),
            jnp.asarray([t], jnp.int32), interpret=True)
        np.testing.assert_array_equal(
            out, norm.inverse(pred[np.asarray(align)[0]]))
