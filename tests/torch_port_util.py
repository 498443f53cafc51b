"""Shared fixtures of the PyTorch port's parity tests: a tiny JAX encoder
with randomized weights and statistics, and its port counterpart; example
dicts; the JAX and the port's ``fit()`` at the tiny geometry."""

import contextlib
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.models.encoder import EMGEncoder as JaxEncoder
from silent_speech_tpu_torch.config import ModelConfig
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.models.encoder import EMGEncoder

# tiny geometry: d=64, 2 layers, 2 heads, ff=128, window m=16
TINY = dict(model_size=64, num_layers=2, num_heads=2, dim_feedforward=128,
            max_dist=16)


def tiny_config(compute_dtype="float32"):
    # dropout and shift off, as in jax_encoder
    return ModelConfig(model_size=64, num_layers=2, num_heads=2,
                       dim_feedforward=128, relative_positional_distance=16,
                       compute_dtype=compute_dtype, dropout=0.0,
                       shift_augment=False)


def jax_encoder(num_outs, num_aux_outs, fused=False, dtype=jnp.float32):
    return JaxEncoder(num_outs=num_outs, num_aux_outs=num_aux_outs,
                      dropout=0.0, fused_attention=fused, dtype=dtype,
                      **TINY)


def random_variables(model, seed=0, t=64):
    """Init ``model`` and randomize every scale/bias leaf and the BatchNorm
    running statistics, so that each mapping is exercised."""
    rng = np.random.default_rng(seed)
    feat = jnp.zeros((1, t, 112), jnp.float32)
    raw = jnp.zeros((1, 8 * t, 8), jnp.float32)
    variables = jax.device_get(
        model.init(jax.random.PRNGKey(seed), feat, raw, train=False))

    def jitter(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "scale":
            return x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
        if name == "bias":
            return 0.1 * rng.normal(size=x.shape).astype(np.float32)
        return x

    def stats(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        return 0.2 * rng.normal(size=x.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(jitter, variables["params"])
    batch_stats = jax.tree_util.tree_map_with_path(
        stats, variables["batch_stats"])
    return {"params": params, "batch_stats": batch_stats}


def port_encoder(variables, num_outs, num_aux_outs,
                 compute_dtype="float32"):
    model = EMGEncoder(num_outs, num_aux_outs, tiny_config(compute_dtype))
    model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]),
        strict=True)
    return model.eval()


def raw_emg(batch, t, seed=1):
    return np.random.default_rng(seed).normal(
        size=(batch, 8 * t, 8)).astype(np.float32)


def to_numpy(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def example_dict(rng, t, silent, t_tgt=None, sess=0, n_text=12,
                 text="a test"):
    """One example in the ``EMGDataset.__getitem__`` schema: T frames of
    random features and raw EMG; a silent one carries a voiced target of
    ``t_tgt`` frames."""
    ex = {"emg": rng.normal(size=(t, 112)).astype(np.float32),
          "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
          "session_ids": np.full(t, sess, np.int64), "silent": silent,
          "text": text,
          "text_int": rng.integers(0, 37, size=n_text).astype(np.int64)}
    tt = (t_tgt or t) if silent else t
    key = "parallel_voiced_audio_features" if silent else "audio_features"
    ex[key] = rng.normal(size=(tt, 80)).astype(np.float32)
    ex["phonemes"] = rng.integers(0, 48, size=tt).astype(np.int64)
    return ex


@contextlib.contextmanager
def jax_prng_impl_restored():
    """Restore JAX's default PRNG implementation on exit. The JAX
    ``TransductionTrainer`` switches the whole process to ``rbg``; a test
    file that builds one holds this around its tests, so that the files a
    pytest worker runs after it draw their JAX weights as before."""
    impl = jax.config.jax_default_prng_impl
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", impl)


@contextlib.contextmanager
def one_torch_thread():
    """Run torch's CPU ops on one thread inside. The tiny shapes of these
    tests gain nothing from more, and the tier-1 run's workers share the
    cores: with a thread per core in each worker, small ops wait on one
    another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def record_calls(obj, name, sink):
    """Wrap the method ``name`` of ``obj`` so that each call's result is
    appended to ``sink``."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink.append(out)
        return out

    setattr(obj, name, wrapped)


def jax_fit(variables, train, dev, out_dir, *, seq_len, lr, warmup,
            max_batch_len, epochs, dropout=0.0, shift=False):
    """The JAX trainer's ``fit()`` at the tiny geometry in float32 from
    ``variables``, on a one-device mesh with chunk bucket 1 and no fixed
    shapes (so no whole padding chunks): (step losses, ``evaluate``
    results). Builds a JAX trainer, which switches the process to the
    ``rbg`` PRNG: call it only from a test file of its own."""
    from silent_speech_tpu.config import Config
    from silent_speech_tpu.parallel.mesh import make_mesh
    from silent_speech_tpu.train.transduction import TransductionTrainer

    cfg = Config()
    m = cfg.model
    m.model_size, m.num_layers, m.num_heads = 64, 2, 2
    m.dim_feedforward, m.relative_positional_distance = 128, 16
    m.dropout, m.compute_dtype, m.shift_augment = dropout, "float32", shift
    m.fused_attention = False
    cfg.data.seq_len, cfg.data.chunk_bucket = seq_len, 1
    cfg.data.fixed_shapes = False
    t = cfg.transduction
    t.learning_rate, t.learning_rate_warmup = lr, warmup
    t.max_batch_len, t.output_directory = max_batch_len, out_dir
    trainer = TransductionTrainer(cfg, mesh=make_mesh(
        1, 1, devices=jax.devices()[:1]))
    trainer.init_state(trainer._pack([train[0]]), seed=0)
    trainer.state = trainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    steps, evals = [], []
    record_calls(trainer, "_train_step", steps)
    record_calls(trainer, "evaluate", evals)
    trainer.fit(train, dev, epochs=epochs, seed=0)
    return [float(m["loss"]) for _, m in steps], evals


def port_fit(variables, train, dev, out_dir, *, seq_len, lr, warmup,
             max_batch_len, epochs, dropout=0.0, shift=False):
    """The port's ``fit()`` on the CPU with the settings of ``jax_fit``:
    (step losses, ``evaluate`` results)."""
    from silent_speech_tpu_torch.config import (DataConfig,
                                                TransductionTrainConfig)
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer

    trainer = TransductionTrainer(
        dataclasses.replace(tiny_config(), dropout=dropout,
                            shift_augment=shift),
        DataConfig(seq_len=seq_len, chunk_bucket=1, fixed_shapes=False),
        TransductionTrainConfig(learning_rate=lr, learning_rate_warmup=warmup,
                                max_batch_len=max_batch_len,
                                output_directory=out_dir),
        device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    steps, evals = [], []
    record_calls(trainer, "train_step", steps)
    record_calls(trainer, "evaluate", evals)
    trainer.fit(train, dev, epochs=epochs, seed=0)
    return [float(o.loss) for o in steps], evals
