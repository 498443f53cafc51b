"""The port's HiFi-GAN generator (``models/hifigan.py``) against the JAX
package's ``generator_apply`` on converted weights, its weight-norm fold
against ``_fold_weight_norm``, and ``Vocoder`` loading an official-format
checkpoint with weight-norm pairs and a sibling ``config.json``."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.models.hifigan import HiFiGANConfig as JaxConfig
from silent_speech_tpu.models.hifigan import (
    _fold_weight_norm, conv_transpose1d, generator_apply,
    hifigan_torch_to_params, init_generator_params)
from silent_speech_tpu_torch.models.convert import hifigan_params_to_torch
from silent_speech_tpu_torch.models.hifigan import (
    Generator, HiFiGANConfig, Vocoder, fold_weight_norm, init_generator,
    weight_norm_state)

from hifigan_util import random_generator_state
from torch_port_util import one_torch_thread

# f32 convolutions, lax on the CPU against torch on the CPU; measured
# ≤ 2e-8 at outputs of ~0.06
ATOL = 1e-6

# tests/test_hifigan.py's SMALL, and a variant with two MRF kernels (the
# mean over resblocks); each with both resblock kinds
SMALL = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
             upsample_initial_channel=32, resblock_kernel_sizes=(3,),
             resblock_dilation_sizes=((1, 2),), num_mels=8)
TWO_KERNELS = dict(SMALL, resblock_kernel_sizes=(3, 5),
                   resblock_dilation_sizes=((1, 2), (1, 3)))


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def _jax_params(cfg, seed):
    """JAX init with every leaf jittered, so biases are not zero."""
    rng = np.random.default_rng(seed)
    params = jax.device_get(init_generator_params(jax.random.PRNGKey(seed),
                                                  cfg))
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(
            np.float32), params)


@pytest.mark.parametrize("shape", [SMALL, TWO_KERNELS],
                         ids=["small", "two-kernels"])
@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_matches_generator_apply(resblock, shape):
    jcfg, cfg = JaxConfig(resblock=resblock, **shape), HiFiGANConfig(
        resblock=resblock, **shape)
    params = _jax_params(jcfg, seed=int(resblock))
    gen = Generator(cfg)
    gen.load_state_dict(hifigan_params_to_torch(params, cfg), strict=True)
    mel = np.random.default_rng(0).normal(size=(2, 13, 8)).astype(
        np.float32)
    ref = np.asarray(generator_apply(params, jnp.asarray(mel), jcfg))
    with torch.no_grad():
        out = gen(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 13 * cfg.hop_length)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rate,k", [(8, 16), (2, 4), (3, 8)],
                         ids=["8-16", "2-4", "odd-k-minus-rate"])
def test_transposed_conv_padding_matches_jax(rate, k):
    # the generator's upsampling: F.conv_transpose1d with padding
    # (k − rate)//2 against JAX's explicit (k−1−p) padding
    rng = np.random.default_rng(rate * k)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4, k)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    p = (k - rate) // 2
    ref = np.asarray(conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), stride=rate,
                                      padding=p))
    up = torch.nn.ConvTranspose1d(6, 4, k, stride=rate, padding=p)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(w))
        up.bias.copy_(torch.from_numpy(b))
        out = up(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def _weight_normed_state(cfg, seed):
    """An official-naming state dict whose convs are weight-norm pairs,
    g drawn apart from ‖v‖ so that the fold matters."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, val in random_generator_state(rng, cfg).items():
        if key.endswith(".weight"):
            base = key[: -len(".weight")]
            g_shape = (val.shape[0],) + (1,) * (val.ndim - 1)
            state[base + ".weight_v"] = val
            state[base + ".weight_g"] = rng.uniform(
                0.5, 2.0, size=g_shape).astype(np.float32)
        else:
            state[key] = val
    return state


def test_fold_weight_norm_matches_jax():
    cfg = HiFiGANConfig(**TWO_KERNELS)
    state = _weight_normed_state(cfg, seed=5)
    ref = _fold_weight_norm(state)
    out = fold_weight_norm({k: torch.from_numpy(v)
                            for k, v in state.items()})
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # the port's inverse gives pairs that fold back to the weights
    folded = fold_weight_norm(weight_norm_state(out))
    for k in out:
        np.testing.assert_allclose(folded[k].numpy(), out[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def _write_checkpoint(directory, cfg, state):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "generator")
    torch.save({"generator": {k: torch.from_numpy(v)
                              for k, v in state.items()}}, path)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"resblock": cfg.resblock,
                   "upsample_rates": list(cfg.upsample_rates),
                   "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
                   "upsample_initial_channel": cfg.upsample_initial_channel,
                   "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
                   "resblock_dilation_sizes": [
                       list(d) for d in cfg.resblock_dilation_sizes],
                   "num_mels": cfg.num_mels}, f)
    return path


def test_vocoder_loads_an_official_checkpoint_with_its_config(tmp_path):
    cfg = HiFiGANConfig(resblock="1", **TWO_KERNELS)
    state = _weight_normed_state(cfg, seed=6)
    path = _write_checkpoint(str(tmp_path / "voc"), cfg, state)
    vocoder = Vocoder(path, device="cpu")
    assert vocoder.cfg == cfg and vocoder.device.type == "cpu"
    mel = np.random.default_rng(7).normal(size=(17, 8)).astype(np.float32)
    audio = vocoder(mel)
    assert audio.shape == (17 * cfg.hop_length,)
    jcfg = JaxConfig.from_json(str(tmp_path / "voc" / "config.json"))
    ref = generator_apply(hifigan_torch_to_params(state, jcfg),
                          jnp.asarray(mel[None]), jcfg)
    np.testing.assert_allclose(audio, np.asarray(ref)[0], atol=ATOL,
                               rtol=0)


def test_vocoder_reads_a_bare_state_dict_and_defaults_to_v1(tmp_path):
    # no sibling config.json: the V1 config, as in JAX
    state = random_generator_state(np.random.default_rng(8),
                                   HiFiGANConfig())
    path = str(tmp_path / "g.pt")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    vocoder = Vocoder(path, device="cpu")
    assert vocoder.cfg == HiFiGANConfig()
    assert vocoder(np.zeros((2, 80), np.float32)).shape == (2 * 256,)


def test_config_json_round_trips_as_jax_reads_it(tmp_path):
    cfg = HiFiGANConfig(resblock="2", **TWO_KERNELS)
    path = str(tmp_path / "config.json")
    cfg.to_json(path)
    assert HiFiGANConfig.from_json(path) == cfg
    j = JaxConfig.from_json(path)
    assert (j.hop_length, j.upsample_rates, j.resblock_dilation_sizes) == (
        cfg.hop_length, cfg.upsample_rates, cfg.resblock_dilation_sizes)


def test_init_generator_is_seeded_and_loads_the_official_layout():
    cfg = HiFiGANConfig(**TWO_KERNELS)
    a = init_generator(cfg, torch.Generator().manual_seed(3)).state_dict()
    b = init_generator(cfg, torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    official = random_generator_state(np.random.default_rng(0), cfg)
    assert set(a) == set(official)
    Generator(cfg).load_state_dict(
        {k: torch.from_numpy(v) for k, v in official.items()}, strict=True)
