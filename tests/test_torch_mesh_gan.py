"""The port's GAN step data-parallel on meshes of gloo processes (2×2 and
4×1, one world of four: both models replicated, the segment batch split
over ``data``,
both updates' gradients averaged over it) against the JAX
``VocoderTrainer`` on a 2-way mesh of the same tiny geometry (check 5 of
the dry run: MPD(2) + MSD(×1) at 1/8 width) from the same weights, and
against one process. The metrics are held within 1e-3 relative of JAX's
(the port's one-process step measured 3e-7 from JAX's in
``test_torch_vocoder_train.py``), and within 1e-5 of one process, the
updated generator within 1e-6."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from silent_speech_tpu.dsp.mel import MelConfig as JaxMelConfig
from silent_speech_tpu.models.hifigan import HiFiGANConfig as JaxConfig
from silent_speech_tpu.parallel.mesh import make_mesh as jax_make_mesh
from silent_speech_tpu.train.vocoder import VocoderTrainer as JaxTrainer
from silent_speech_tpu_torch.dsp.mel import MelConfig
from silent_speech_tpu_torch.models.convert import (
    discriminator_params_to_torch, hifigan_params_to_torch)
from silent_speech_tpu_torch.models.hifigan import HiFiGANConfig
from silent_speech_tpu_torch.parallel import launch

import torch_mesh_workers as workers
from torch_port_util import one_torch_thread

MESHES = [(2, 2), (4, 1)]
IDS = [f"{dp}x{mp}" for dp, mp in MESHES]
JAX_RTOL, ONE_RTOL, WEIGHT_ATOL = 1e-3, 1e-5, 1e-6
TINY_GEN = dict(resblock="1", upsample_rates=(4, 2),
                upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                num_mels=80)
TINY_MEL = dict(n_fft=64, num_mels=80, hop_size=8, win_size=64, fmax=8000.0)
TINY_DISC = dict(disc_periods=(2,), disc_scales=1, disc_width_div=8)


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def gan():
    """JAX's GAN step on a 2-way data mesh, and the port's arguments for
    the same step from the same weights (a batch of 4 segments)."""
    jt = JaxTrainer(gen_cfg=JaxConfig(**TINY_GEN),
                    mel_cfg=JaxMelConfig(**TINY_MEL), learning_rate=1e-3,
                    seed=0, mesh=jax_make_mesh(2, 1,
                                               devices=jax.devices()[:2]),
                    **TINY_DISC)
    gen_cfg = HiFiGANConfig(**TINY_GEN)
    rng = np.random.default_rng(2)
    mels = (0.1 * rng.normal(size=(4, 16, 80))).astype(np.float32)
    audio = (0.3 * rng.normal(size=(4, 16 * 8))).astype(np.float32)
    args = dict(gen_state=hifigan_params_to_torch(
                    jax.device_get(jt.gen_params), gen_cfg),
                disc_state=discriminator_params_to_torch(
                    jax.device_get(jt.disc_params)),
                mels=mels, audio=audio, lr=1e-3, gen_cfg=gen_cfg,
                mel_cfg=MelConfig(**TINY_MEL), disc=TINY_DISC)
    *_, ref = jt._step(jt.gen_params, jt.disc_params, jt.gen_opt,
                       jt.disc_opt, jnp.asarray(mels), jnp.asarray(audio),
                       np.float32(1e-3))
    return args, {k: float(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def steps(gan):
    return launch.spawn(workers.gan_steps, 4, (MESHES, gan[0]),
                        threads=1)[0]


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_gan_step_matches_jax_s_two_way_mesh(steps, gan, mesh):
    got, _ = steps[mesh]
    want = gan[1]
    for k in ("g_loss", "d_loss", "mel_l1"):
        assert abs(got[k] - want[k]) <= JAX_RTOL * abs(want[k]), \
            (k, got[k], want[k])


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_gan_step_on_a_mesh_matches_one_process(steps, gan, mesh):
    metrics, state = workers.gan_step(None, **gan[0])
    got, got_state = steps[mesh]
    for k, v in metrics.items():
        assert abs(got[k] - v) <= ONE_RTOL * abs(v), k
    for k, v in state.items():
        np.testing.assert_allclose(got_state[k].numpy(), v.numpy(),
                                   atol=WEIGHT_ATOL, err_msg=k)
