"""EMG→mel transduction training: one step at a time.

Counterpart of ``TransductionTrainer`` in the JAX package
(``silent_speech_tpu/train/transduction.py``): batches are packed on the
host into one fixed shape (``_pack``), uploaded, and each ``train_step``
runs the encoder forward with shift augmentation and dropout, the
transduction loss (DTW on the silent rows), the backward and the AdamW
update. The step returns its loss, phoneme hits and target length as
tensors on the device, so consecutive steps queue without waiting for the
card. Randomness (weights, shift, dropout seeds) comes from explicit CPU
``torch.Generator``s. It runs on ``cuda`` unless given ``device="cpu"``.

The JAX trainer's wave and scan steps amortize the dispatch to a remote
TPU and have no counterpart here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import DataConfig, ModelConfig, TransductionTrainConfig
from ..data.packing import PackedBatch, pack_batch
from ..models.encoder import EMGEncoder
from ..phonemes import NUM_PHONES
from ..utils.device import resolve_device
from .losses import TransductionLossOut, transduction_loss
from .state import FusedAdamW


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DeviceBatch(NamedTuple):
    """The tensors of a ``PackedBatch`` that the step reads, on the
    device."""

    raw_emg: torch.Tensor
    utt_gather_idx: torch.Tensor
    utt_len: torch.Tensor
    target_len: torch.Tensor
    phonemes: torch.Tensor
    silent: torch.Tensor
    audio_features: torch.Tensor


def upload(batch: PackedBatch, device: torch.device) -> DeviceBatch:
    return DeviceBatch(*(torch.from_numpy(np.ascontiguousarray(
        getattr(batch, name))).to(device) for name in DeviceBatch._fields))


class TransductionTrainer:
    def __init__(self, model_cfg: Optional[ModelConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 train_cfg: Optional[TransductionTrainConfig] = None,
                 num_mel_bins: int = 80,
                 device: Optional[Union[str, torch.device]] = None):
        self.model_cfg = model_cfg or ModelConfig()
        self.data_cfg = data_cfg or DataConfig()
        self.train_cfg = train_cfg or TransductionTrainConfig()
        self.device = resolve_device(device)
        self.dtype = getattr(torch, self.model_cfg.compute_dtype)
        self.num_mel_bins = num_mel_bins
        self.model: Optional[EMGEncoder] = None
        self.optimizer: Optional[FusedAdamW] = None
        self.generator: Optional[torch.Generator] = None

    def init_state(self, seed: int = 0) -> EMGEncoder:
        """Random weights from ``seed``, zeroed AdamW moments, and the
        step generator (shift and dropout draws) from ``seed + 1``."""
        model = EMGEncoder(self.num_mel_bins, NUM_PHONES, self.model_cfg)
        model.init_weights(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.optimizer = FusedAdamW(
            self.model.parameters(), weight_decay=self.train_cfg.l2,
            moment_dtype=getattr(torch, self.train_cfg.moment_dtype))
        self.generator = torch.Generator().manual_seed(seed + 1)
        return self.model

    @property
    def frames_cap(self) -> int:
        """Packed feature frames implied by the raw-sample batch capacity
        (1 kHz capture → 516.79 Hz → frame hop 6, reference
        ``read_emg.py:70-88``)."""
        return int(self.train_cfg.max_batch_len * (516.79 / 1000.0) / 6.0)

    def _pack(self, examples: List[dict]) -> PackedBatch:
        d = self.data_cfg
        fixed_chunks = fixed_utts = fixed_t = None
        if d.fixed_shapes:
            fixed_t = d.t_cap
            fixed_utts = d.utt_cap
            fixed_chunks = _round_up(-(-self.frames_cap // d.seq_len) + 2,
                                     d.chunk_bucket)
        return pack_batch(examples, seq_len=d.seq_len,
                          chunk_bucket=d.chunk_bucket, utt_bucket=8,
                          fixed_chunks=fixed_chunks, fixed_utts=fixed_utts,
                          fixed_t=fixed_t)

    def _loss(self, db: DeviceBatch, batch: PackedBatch, train: bool,
              **kwargs) -> TransductionLossOut:
        pred, phone = self.model(db.raw_emg, train=train,
                                 generator=self.generator)
        return transduction_loss(
            pred, phone, db, self.train_cfg.phoneme_loss_weight,
            n_silent=batch.num_silent, **kwargs)

    def train_step(self, batch: PackedBatch, lr: float
                   ) -> TransductionLossOut:
        """One optimizer step on ``batch`` at learning rate ``lr``. Each
        parameter's ``.grad`` holds this step's gradient afterwards."""
        if self.model is None:
            raise RuntimeError("call init_state() before train_step()")
        db = upload(batch, self.device)
        for p in self.model.parameters():
            p.grad = None
        out = self._loss(db, batch, True, matmul_dtype=self.dtype)
        out.loss.backward()
        self.optimizer.step(lr)
        return out._replace(loss=out.loss.detach())

    @torch.no_grad()
    def eval_step(self, batch: PackedBatch) -> TransductionLossOut:
        """The eval forward and the loss in float32, with the phoneme
        confusion matrix."""
        if self.model is None:
            raise RuntimeError("call init_state() before eval_step()")
        return self._loss(upload(batch, self.device), batch, False,
                          phoneme_eval=True)
