"""Synthesis outputs and model ensembling.

Counterpart of the JAX package's ``silent_speech_tpu/eval/synthesis.py``:
``save_output`` (reference ``transduction_model.py:57-73``) predicts one
utterance, inverts the mel normalizer, vocodes and writes a 22.05 kHz wav;
``dump_all_outputs`` does so for a whole dataset; ``EnsemblePredictor``
(reference ``EnsembleModel``, ``evaluate.py:22-34``) averages the mel and
phoneme heads of N transduction models of one architecture. The N
forwards run one after another, each through the attention kernel (the
JAX package vmaps one forward over stacked weights; the kernel is not
batched over weights).
"""

from __future__ import annotations

import os
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.encoder import EMGEncoder
from ..phonemes import NUM_PHONES
from ..train.transduction import aligned_prediction
from ..utils.audio_io import write_wav


def save_output(trainer, example: dict, filename: str, audio_normalizer,
                vocoder) -> np.ndarray:
    """Predict → denormalize → vocode → write a 22.05 kHz wav; returns the
    audio. ``trainer`` is anything with ``predict(example)`` (a
    ``TransductionTrainer`` or an ``EnsemblePredictor``), ``vocoder`` maps
    a (T, 80) mel to a waveform (``models.hifigan.Vocoder``)."""
    mel = audio_normalizer.inverse(trainer.predict(example))
    audio = np.asarray(vocoder(mel))
    write_wav(filename, audio, 22050)
    return audio


def dump_all_outputs(trainer, dataset, output_directory: str,
                     audio_normalizer, vocoder,
                     prefix: str = "example_output") -> List[str]:
    """Write ``{prefix}_{i}.wav`` for every example (reference
    ``transduction_model.py:222-223``, ``evaluate.py:61-62``); returns the
    paths."""
    os.makedirs(output_directory, exist_ok=True)
    paths = []
    for i in range(len(dataset)):
        path = os.path.join(output_directory, f"{prefix}_{i}.wav")
        save_output(trainer, dataset[i], path, audio_normalizer, vocoder)
        paths.append(path)
    return paths


class EnsemblePredictor:
    """The mean of ``models``' two heads, evaluated with ``trainer``'s
    packing and loss (a ``TransductionTrainer``: its device, data
    configuration and phoneme loss weight)."""

    def __init__(self, trainer, models: Sequence[EMGEncoder]):
        if not models:
            raise ValueError("an ensemble needs at least one model")
        self.trainer = trainer
        self.models = [m.to(trainer.device).eval() for m in models]

    @classmethod
    def from_state_dicts(cls, trainer,
                         states: Sequence[Mapping[str, torch.Tensor]]
                         ) -> "EnsemblePredictor":
        """Models of ``trainer``'s architecture, each loaded strictly from
        a reference-layout state dict (a ``model.pt``)."""
        models = []
        for state in states:
            model = EMGEncoder(trainer.num_mel_bins, NUM_PHONES,
                               trainer.model_cfg)
            model.load_state_dict(state, strict=True)
            models.append(model)
        return cls(trainer, models)

    def heads(self, x_raw: torch.Tensor, valid_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval forward of each model in turn; the mean of the mel
        predictions and of the phoneme logits."""
        preds, phones = zip(*(m(x_raw, valid_len) for m in self.models))
        return torch.stack(preds).mean(0), torch.stack(phones).mean(0)

    @torch.no_grad()
    def predict(self, example: dict) -> np.ndarray:
        """(T, 80) mean normalized mel prediction for one utterance, padded
        as ``TransductionTrainer.predict`` pads it."""
        raw, t = self.trainer.pad_single(example)
        pred, _ = self.heads(torch.from_numpy(raw).to(self.trainer.device),
                             valid_len=t)
        return pred[0, :t].cpu().numpy()

    def evaluate(self, dataset, batch_size: int = 32
                 ) -> Tuple[float, float, np.ndarray]:
        """Loss, phoneme accuracy and (48, 48) confusion of the ensemble:
        both heads are averaged before the transduction loss, over the
        trainer's eval groups (reference ``evaluate.py:27-34``)."""
        return self.trainer.evaluate(dataset, batch_size, model=self.heads)

    def get_aligned_prediction(self, example: dict, audio_normalizer
                               ) -> np.ndarray:
        """The ensemble's prediction, DTW-warped onto the voiced target of a
        silent utterance (the kernel at K = 1 on the card), denormalized."""
        return aligned_prediction(self.predict(example), example,
                                  audio_normalizer, self.trainer.device)
