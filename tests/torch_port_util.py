"""Shared fixtures of the PyTorch port's parity tests: a tiny JAX encoder
with randomized weights and statistics, and its port counterpart."""

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
    return ModelConfig(model_size=64, num_layers=2, num_heads=2,
                       dim_feedforward=128, relative_positional_distance=16,
                       compute_dtype=compute_dtype)


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
