"""Typed configuration: the fields of the JAX package's configuration
(``silent_speech_tpu/config.py``) that the eval forward and the
transduction training step need, with the same names and defaults."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelConfig:
    """Encoder architecture (reference ``architecture.py:10-12,42-59``)."""

    model_size: int = 768
    num_layers: int = 6
    dropout: float = 0.2
    num_heads: int = 8
    dim_feedforward: int = 3072
    relative_positional_distance: int = 100
    raw_channels: int = 8          # EMG electrodes into the conv stack
    # matmul/conv precision of the encoder body; params, norms and the
    # heads' outputs stay float32
    compute_dtype: str = "bfloat16"
    # train-time random left shift of the raw signal by 0..7 samples
    # (reference ``architecture.py:64-68``)
    shift_augment: bool = True


@dataclass
class DataConfig:
    """Packing of training batches (reference ``transduction_model.py:191``
    for ``seq_len``)."""

    seq_len: int = 200     # frames per packed chunk; raw chunks are 8x
    chunk_bucket: int = 8  # round the chunk count up to a multiple of this
    # pad every batch to the capacity-derived caps below, so that every
    # step sees one shape
    fixed_shapes: bool = True
    utt_cap: int = 64      # utterances per packed batch
    t_cap: int = 1024      # frames per utterance (about 12 s at 86 fps)


@dataclass
class TransductionTrainConfig:
    """EMG→mel training (reference ``transduction_model.py:22-31``)."""

    learning_rate: float = 1e-3
    learning_rate_patience: int = 5
    learning_rate_warmup: int = 500
    phoneme_loss_weight: float = 0.5
    l2: float = 1e-7
    # Adam moment storage; the update math is float32 either way
    moment_dtype: str = "bfloat16"
    # batch capacity in raw-recording EMG samples
    # (reference ``transduction_model.py:166``)
    max_batch_len: int = 256000
