"""The JAX ``TransductionTrainer`` on a 2×2 mesh of virtual CPU devices
(float32, dropout 0, the shift off) against the port's trainer on a 2×2
mesh of gloo processes, from the JAX trainer's initial weights carried
over by ``jax_to_torch``, on the same packed batch: the first step's loss
within 2e-4 relative. A file of its own: the JAX trainer switches the
process to the ``rbg`` PRNG (restored at the end), and its mesh step's
CPU compile is this file's cost."""

import numpy as np

import jax
from silent_speech_tpu.config import Config
from silent_speech_tpu.parallel.mesh import make_mesh, shard_batch
from silent_speech_tpu.train.transduction import TransductionTrainer
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.parallel import launch

import torch_mesh_workers as workers
from torch_port_util import jax_prng_impl_restored, one_torch_thread

LOSS_RTOL = 2e-4


def _jax_config():
    cfg = Config()
    m = cfg.model
    m.model_size, m.num_layers, m.num_heads = 64, 2, 2
    m.dim_feedforward, m.relative_positional_distance = 128, 16
    m.dropout, m.compute_dtype, m.shift_augment = 0.0, "float32", False
    m.fused_attention = False
    d = cfg.data
    d.seq_len, d.t_cap, d.utt_cap = (workers.DATA[k] for k in
                                     ("seq_len", "t_cap", "utt_cap"))
    cfg.transduction.max_batch_len = 8000
    return cfg


def test_jax_two_by_two_mesh_step_matches_the_port_s():
    with jax_prng_impl_restored():
        mesh = make_mesh(2, 2, devices=jax.devices()[:4])
        trainer = TransductionTrainer(_jax_config(), mesh=mesh)
        packed = trainer._pack(workers.examples())
        trainer.init_state(packed, seed=0)
        state = jax_to_torch(jax.device_get(trainer.state.params),
                             jax.device_get(trainer.state.batch_stats))
        _, metrics = trainer._train_step(
            trainer.state, shard_batch(packed.device_batch(), mesh),
            jax.random.PRNGKey(0), np.float32(workers.LR), packed.num_silent)
        want = float(metrics["loss"])
    with one_torch_thread():
        got = launch.spawn(workers.loaded_step, 4, (2, 2, state),
                           threads=1)[0]
    assert np.isfinite(want)
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
