"""Typed configuration: the fields of the JAX package's configuration
(``silent_speech_tpu/config.py``) that the eval forward, the two trainers
and their dataset need, with the same names and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence


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
class MeshConfig:
    """The data × model mesh (``parallel/mesh.py``), the JAX
    configuration's ``MeshConfig``."""

    # -1 = every rank the model axis leaves goes on the data axis
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass
class DataConfig:
    """Dataset discovery (reference ``read_emg.py:21-25``) and the packing
    of training batches (reference ``transduction_model.py:191`` for
    ``seq_len``)."""

    remove_channels: List[int] = field(default_factory=list)
    silent_data_directories: List[str] = field(
        default_factory=lambda: ["./emg_data/silent_parallel_data"])
    voiced_data_directories: List[str] = field(
        default_factory=lambda: ["./emg_data/voiced_parallel_data",
                                 "./emg_data/nonparallel_data"])
    testset_file: str = "testset_largedev.json"
    text_align_directory: str = "text_alignments"
    normalizers_file: str = "normalizers.pkl"
    seq_len: int = 200     # frames per packed chunk; raw chunks are 8x
    chunk_bucket: int = 8  # round the chunk count up to a multiple of this
    # pad every batch to the capacity-derived caps below, so that every
    # step sees one shape
    fixed_shapes: bool = True
    utt_cap: int = 64      # utterances per packed batch
    t_cap: int = 1024      # frames per utterance (about 12 s at 86 fps)
    # keep the training corpus on the device and assemble each batch there
    # from its utterance ids (``data/device_cache.py``); needs fixed_shapes
    device_cache: bool = True
    # share of the card's memory the corpus may take; over it, training
    # packs on the host. <= 0 disables the check
    cache_hbm_fraction: float = 0.4
    # how a corpus on disk is featurized for the device corpus: "device"
    # (``data/device_featurize.py``, the filter chain as one kernel) or
    # "host" (``EMGDataset.__getitem__``); the JAX package's "jax"
    cache_featurize: str = "device"


@dataclass
class TransductionTrainConfig:
    """EMG→mel training (reference ``transduction_model.py:22-31``)."""

    epochs: int = 80
    learning_rate: float = 1e-3
    learning_rate_patience: int = 5
    learning_rate_warmup: int = 500
    start_training_from: Optional[str] = None
    data_size_fraction: float = 1.0
    phoneme_loss_weight: float = 0.5
    l2: float = 1e-7
    # Adam moment storage; the update math is float32 either way
    moment_dtype: str = "bfloat16"
    output_directory: str = "output"
    # batch capacity in raw-recording EMG samples
    # (reference ``transduction_model.py:166``)
    max_batch_len: int = 256000


@dataclass
class RecognitionTrainConfig:
    """EMG→text CTC training (reference ``recognition_model.py:20-28``)."""

    batch_size: int = 32   # unused, as in the reference
    epochs: int = 200
    learning_rate: float = 3e-4
    learning_rate_warmup: int = 1000
    learning_rate_patience: int = 5
    start_training_from: Optional[str] = None
    l2: float = 0.0
    moment_dtype: str = "bfloat16"  # see TransductionTrainConfig
    output_directory: str = "output"
    evaluate_saved: Optional[str] = None
    debug: bool = False
    max_batch_len: int = 128000   # ``recognition_model.py:62``
    grad_accum: int = 2           # ``recognition_model.py:105-107``
    lr_milestones: Sequence[int] = (125, 150, 175)
    lr_gamma: float = 0.5
    # beam decode (reference ``recognition_model.py:34-35``)
    lm_path: str = "lm.binary"
    lm_alpha: float = 1.5
    lm_beta: float = 1.85
    beam_width: int = 100
