"""Encoder architecture: the fields of the JAX package's ``ModelConfig``
(``silent_speech_tpu/config.py``) that the eval forward needs."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelConfig:
    """Encoder architecture (reference ``architecture.py:10-12,42-59``)."""

    model_size: int = 768
    num_layers: int = 6
    num_heads: int = 8
    dim_feedforward: int = 3072
    relative_positional_distance: int = 100
    raw_channels: int = 8          # EMG electrodes into the conv stack
    # matmul/conv precision of the encoder body; params, norms and the
    # heads' outputs stay float32
    compute_dtype: str = "bfloat16"
