"""Rank functions of the mesh tests: each runs in every process that
``silent_speech_tpu_torch.parallel.launch.spawn`` starts, on a gloo mesh
of the CPU, and returns what the test compares (rank 0's gathered values;
the other ranks return None). This module imports nothing of JAX, so the
ranks start quickly."""

import os

import numpy as np
import torch

from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                            RecognitionTrainConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.parallel.mesh import (full_model, gather_state,
                                                   gather_tensor, make_mesh)
from silent_speech_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

# the tiny geometry of the port's parity tests, in float32
DATA = dict(seq_len=50, t_cap=128, utt_cap=8)
LR = 1e-3


def model_config(dropout=0.0, shift=False):
    return ModelConfig(model_size=64, num_layers=2, num_heads=2,
                       dim_feedforward=128, relative_positional_distance=16,
                       compute_dtype="float32", dropout=dropout,
                       shift_augment=shift)


def examples(seed=0, n=6):
    """Silent and voiced example dicts of 20-90 frames."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        silent = i % 2 == 0
        t = int(rng.integers(20, 90))
        tt = int(t * rng.uniform(0.9, 1.15)) if silent else t
        ex = {"emg": rng.normal(size=(t, 112)).astype(np.float32),
              "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
              "session_ids": np.zeros(t, np.int64), "silent": silent,
              "text": "a test",
              "text_int": rng.integers(0, 37, size=10).astype(np.int64)}
        key = "parallel_voiced_audio_features" if silent else "audio_features"
        ex[key] = rng.normal(size=(tt, 80)).astype(np.float32)
        ex["phonemes"] = rng.integers(0, 48, size=tt).astype(np.int64)
        out.append(ex)
    return out


def transduction_trainer(mesh=None, dropout=0.0, max_batch_len=8000,
                         out_dir="unused"):
    return TransductionTrainer(
        model_config(dropout, shift=dropout > 0), DataConfig(**DATA),
        TransductionTrainConfig(max_batch_len=max_batch_len,
                                output_directory=out_dir),
        device="cpu", mesh=mesh)


def recognition_trainer(mesh=None):
    return RecognitionTrainer(
        model_config(), DataConfig(**DATA),
        RecognitionTrainConfig(max_batch_len=8000, grad_accum=2),
        device="cpu", mesh=mesh)


def _grads(model, mesh):
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[name] = g.detach().clone() if mesh is None \
            else gather_tensor(name, g.detach(), mesh)
    return grads


def transduction_step(trainer, exs, seed=0):
    """The loss and the gradients (in full) of one step from ``seed``."""
    trainer.init_state(seed)
    out = trainer.train_step(trainer._pack(exs), LR)
    return float(out.loss), _grads(trainer.model, trainer.mesh)


def recognition_steps(trainer, exs, n=3):
    """The losses of ``n`` micro-steps (accumulation of 2: the third sees
    the updated weights) and the weights after them, in full."""
    trainer.init_state(0)
    batch = trainer._pack(exs)
    losses = [float(trainer.train_step(batch, LR)) for _ in range(n)]
    return losses, _full_state(trainer)


def _full_state(trainer):
    """The full state dict, copied (a replicated entry would otherwise be
    the live parameter)."""
    state = {k: v.detach() for k, v in trainer.model.state_dict().items()}
    if trainer.mesh is not None:
        state = gather_state(state, trainer.mesh)
    return {k: v.clone() for k, v in state.items()}


def mesh_suites(shapes, work):
    """``mesh_suite`` on each (dp, mp) of ``shapes``, meshes of the same
    ranks in turn; rank 0 returns {shape: results}."""
    out = {}
    for dp, mp in shapes:
        d = os.path.join(work, f"{dp}x{mp}")
        out[(dp, mp)] = mesh_suite(dp, mp, os.path.join(d, "ckpt"),
                                   os.path.join(d, "bundle"))
    return out if out[shapes[0]] is not None else None


def mesh_suite(dp, mp, ckpt_dir, bundle_dir):
    """On a dp × mp mesh: the transduction step at dropout 0 and 0.2, the
    recognition micro-steps, a checkpoint saved after one step and
    restored onto a (dp·mp) × 1 mesh of the same ranks and onto one
    process (rank 0), and a serving bundle exported from the sharded
    trainer. Returns rank 0's results."""
    from silent_speech_tpu_torch.eval.export import save_serving_bundle

    mesh = make_mesh(dp, mp, device="cpu")
    exs = examples()
    res = {"bundle_dir": bundle_dir}
    for dropout in (0.0, 0.2):
        res[("step", dropout)] = transduction_step(
            transduction_trainer(mesh, dropout), exs)
    res["recognition"] = recognition_steps(recognition_trainer(mesh), exs)

    # export from the sharded trainer, before any step: the weights are
    # the one-process init's, sliced
    t = transduction_trainer(mesh)
    t.init_state(0)
    full = full_model(t.model)
    if mesh.rank == 0:
        save_serving_bundle(full, "transduction", bundle_dir)

    # checkpoint after one step, then restore across topologies
    os.makedirs(ckpt_dir, exist_ok=True)
    t.train_step(t._pack(exs), LR)
    save_checkpoint(ckpt_dir, t, extra={"epoch": 1})
    saved = _full_state(t)
    n = dp * mp
    mesh_t = make_mesh(n, 1, device="cpu")
    tt = transduction_trainer(mesh_t)
    tt.init_state(5)
    extra = restore_checkpoint(ckpt_dir, tt)
    restored = _full_state(tt)
    res["restore_nx1"] = (extra, all(torch.equal(saved[k], restored[k])
                                     for k in saved),
                          float(tt.train_step(tt._pack(exs), LR).loss))
    res["restore_src"] = float(t.train_step(t._pack(exs), LR).loss)
    if mesh.rank == 0:
        one = transduction_trainer()
        one.init_state(7)
        restore_checkpoint(ckpt_dir, one)
        state = one.model.state_dict()
        res["restore_1x1"] = (all(torch.equal(saved[k], state[k])
                                  for k in saved),
                              float(one.train_step(one._pack(exs), LR).loss))
    return res if mesh.rank == 0 else None


def gan_steps(shapes, gan):
    """``gan_step`` on each (dp, mp) mesh of ``shapes`` in turn; rank 0
    returns {shape: (metrics, generator state)}."""
    out = {shape: gan_step(make_mesh(*shape, device="cpu"), **gan)
           for shape in shapes}
    import torch.distributed as dist

    return out if dist.get_rank() == 0 else None


def gan_step(mesh, gen_state, disc_state, mels, audio, lr, gen_cfg,
             mel_cfg, disc):
    """One GAN step of the port on ``mesh`` (None: one process) from the
    given weights: the metrics and the generator's updated weights."""
    from silent_speech_tpu_torch.train.vocoder import VocoderTrainer

    vt = VocoderTrainer(gen_cfg=gen_cfg, mel_cfg=mel_cfg, learning_rate=lr,
                        seed=0, device="cpu", mesh=mesh, **disc)
    vt.generator.load_state_dict(gen_state, strict=True)
    vt.disc.load_state_dict(disc_state, strict=True)
    out = vt.train_step(mels, audio, lr)
    return ({k: float(v) for k, v in out.items()},
            {k: v.detach().clone()
             for k, v in vt.generator.state_dict().items()})


def rank_env(_):
    """This rank's mesh coordinates (a launch check)."""
    mesh = make_mesh(-1, 2, device="cpu")
    return (mesh.rank, mesh.data_rank, mesh.model_rank,
            int(os.environ["LOCAL_RANK"]))


def state_round_trip(dp, mp):
    """After a step on a dp × mp mesh: the gathered state and moments,
    sharded again, are the rank's own, and gathered again, the whole;
    returns (all exact, sharded entries, entries)."""
    from silent_speech_tpu_torch.parallel.mesh import (param_partition_spec,
                                                       shard_state)

    mesh = make_mesh(dp, mp, device="cpu")
    t = transduction_trainer(mesh)
    t.init_state(0)
    t.train_step(t._pack(examples()), LR)
    names = [n for n, _ in t.model.named_parameters()]
    parts = [{k: v.detach().clone()
              for k, v in t.model.state_dict().items()}]
    parts += [{n: m.clone() for n, m in zip(names, moments)}
              for moments in (t.optimizer.mu, t.optimizer.nu)]
    equal, n_sharded, n_total = True, 0, 0
    for local in parts:
        full = {k: v.clone() for k, v in gather_state(local, mesh).items()}
        again = gather_state(shard_state(full, mesh), mesh)
        equal &= all(torch.equal(local[k], v)
                     for k, v in shard_state(full, mesh).items())
        equal &= all(torch.equal(full[k], again[k]) for k in full)
        n_sharded += sum(param_partition_spec(k) is not None for k in full)
        n_total += len(full)
    return equal, n_sharded, n_total


def fail_on_rank_one(_):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        return 1 / 0
    return 0


def loaded_step(dp, mp, state):
    """The loss of one transduction step on a dp × mp mesh from the full
    reference-layout ``state``, on ``examples()``."""
    from silent_speech_tpu_torch.parallel.mesh import shard_state

    mesh = make_mesh(dp, mp, device="cpu")
    t = transduction_trainer(mesh)
    t.init_state(0)
    t.model.load_state_dict(shard_state(state, mesh), strict=True)
    return float(t.train_step(t._pack(examples()), LR).loss)
