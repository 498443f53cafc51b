"""EMG→mel transduction training: steps, the training run, inference.

Counterpart of ``TransductionTrainer`` in the JAX package
(``silent_speech_tpu/train/transduction.py``). The batches, the
micro-step, an epoch's steps and the mesh are the shared core's
(``train/encoder_trainer.py``); this trainer gives the encoder's mel and
phoneme heads, batches with the voiced audio, and the transduction loss
(DTW on the silent rows), which a step returns with its phoneme hits and
target length as tensors on the device, so consecutive steps queue
without waiting for the card. ``fit`` runs epochs of steps over a dataset
with the warmup × plateau learning rate, validates, writes ``log.txt``
lines, checkpoints and resumes; it reads the step losses once an epoch.
``get_aligned_prediction`` warps one utterance's prediction onto its
voiced target through the DTW kernel. Randomness (weights, shift, dropout
seeds) comes from explicit CPU ``torch.Generator``s. It runs on ``cuda``
unless given ``device="cpu"``. On a mesh, rank 0 alone writes ``log.txt``
lines and files.

The JAX trainer's wave and scan steps amortize the dispatch to a remote
TPU and have no counterpart here.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import DataConfig, ModelConfig, TransductionTrainConfig
from ..data.packing import DeviceBatch, PackedBatch, upload
from ..data.sampler import SizeAwareSampler
from ..models.encoder import EMGEncoder
from ..ops.dtw import dtw_align_batch
from ..phonemes import NUM_PHONES
from ..utils.profiling import span
from .checkpoint import checkpoint_exists, is_writer, restore_checkpoint
from .encoder_trainer import EncoderTrainer
from .losses import TransductionLossOut, transduction_loss
from .schedule import ReduceLROnPlateau

__all__ = ["DeviceBatch", "TransductionTrainer", "aligned_prediction",
           "upload"]

# an eval forward: raw EMG (B, 8T, C) → (mel (B, T, 80), phone logits)
Forward = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class TransductionTrainer(EncoderTrainer):
    WITH_AUDIO = True

    def __init__(self, model_cfg: Optional[ModelConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 train_cfg: Optional[TransductionTrainConfig] = None,
                 num_mel_bins: int = 80,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        super().__init__(model_cfg, data_cfg,
                         train_cfg or TransductionTrainConfig(), device, mesh)
        self.num_mel_bins = num_mel_bins

    def _heads(self) -> Tuple[int, Optional[int]]:
        return self.num_mel_bins, NUM_PHONES

    # ---------------- steps -------------------------------------------
    def _loss(self, out, db: DeviceBatch, n_silent: Optional[int],
              **kwargs) -> TransductionLossOut:
        pred, phone = out
        return transduction_loss(pred, phone, db,
                                 self.train_cfg.phoneme_loss_weight,
                                 n_silent=n_silent, **kwargs)

    def _train_loss(self, out, db: DeviceBatch, n_silent: int
                    ) -> Tuple[torch.Tensor, TransductionLossOut]:
        res = self._loss(out, db, n_silent, matmul_dtype=self.dtype)
        return res.loss, res._replace(loss=res.loss.detach())

    @staticmethod
    def _step_loss(result: TransductionLossOut) -> torch.Tensor:
        return result.loss

    @torch.no_grad()
    def eval_step(self, batch: PackedBatch, model: Optional[Forward] = None
                  ) -> TransductionLossOut:
        """The eval forward and the loss in float32, with the phoneme
        confusion matrix. ``model`` maps the raw EMG to the two heads in
        place of the trainer's model (an ensemble's mean)."""
        if self.model is None and model is None:
            raise RuntimeError("call init_state() before eval_step()")
        db = upload(batch, self.device)
        out = (self.model if model is None else model)(db.raw_emg)
        with span("ssp.loss"):
            return self._loss(out, db, batch.num_silent, phoneme_eval=True)

    # ---------------- the training run --------------------------------
    def batches(self, dataset, max_len: Optional[int] = None,
                seed: Optional[int] = None) -> Iterable[PackedBatch]:
        sampler = SizeAwareSampler(
            dataset, max_len or self.train_cfg.max_batch_len, seed=seed)
        for idx_batch in sampler:
            yield self._pack([dataset[i] for i in idx_batch])

    def fit(self, trainset, devset, epochs: Optional[int] = None,
            vocoder=None, save_sound_outputs: bool = False,
            seed: int = 0, resume: bool = False,
            eval_every: int = 1) -> EMGEncoder:
        """Train for ``epochs`` (default ``train_cfg.epochs``) over
        ``trainset``, any dataset with ``__len__``, ``__getitem__`` and
        ``example_meta``; validate on ``devset`` every ``eval_every`` epochs
        and after the last, and checkpoint into
        ``train_cfg.output_directory`` every epoch. ``resume=True``
        restores the checkpoint there. As in JAX, the sampler is built
        after the restore, so a resumed run shuffles its first epoch as
        epoch 0. The step losses stay on the device and are read once an
        epoch; a non-finite epoch loss raises ``FloatingPointError``. With
        ``save_sound_outputs`` and a ``vocoder``, each epoch also writes
        ``epoch_{epoch}_output.wav``, ``devset[0]`` vocoded (reference
        ``transduction_model.py:224-226``)."""
        cfg = self.train_cfg
        epochs = epochs if epochs is not None else cfg.epochs
        if cfg.data_size_fraction < 1:
            trainset = trainset.subset(cfg.data_size_fraction)

        plateau = ReduceLROnPlateau(patience=cfg.learning_rate_patience)
        global_step = 0
        start_epoch = 0
        os.makedirs(cfg.output_directory, exist_ok=True)
        if self.model is None:
            self.init_state(seed)
        writer = is_writer(self.model)
        if resume and checkpoint_exists(cfg.output_directory):
            extra = restore_checkpoint(cfg.output_directory, self)
            global_step = int(extra.get("global_step", self.optimizer.count))
            start_epoch = int(extra.get("epoch", 0))
            for k, v in extra.get("plateau", {}).items():
                setattr(plateau, k, v)
            logging.info("resumed from epoch %d (step %d)", start_epoch,
                         global_step)

        # one sampler across epochs: a fresh shuffle each epoch
        sampler = SizeAwareSampler(trainset, cfg.max_batch_len, seed=seed)
        corpus = self.build_corpus(trainset)

        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            train_loss, steps = self._train_epoch(
                epoch, trainset, sampler, corpus, global_step, plateau.scale)
            global_step += steps
            dt = time.time() - t0

            last = epoch + 1 == epochs
            if (epoch + 1) % max(eval_every, 1) == 0 or last:
                val_loss, phoneme_acc, _ = self.evaluate(devset)
                plateau.step(val_loss)
                logging.info(
                    f"finished epoch {epoch + 1} - validation loss: "
                    f"{val_loss:.4f} training loss: {train_loss:.4f} "
                    f"phoneme accuracy: {phoneme_acc * 100:.2f}")
            else:
                logging.info(f"finished epoch {epoch + 1} - training "
                             f"loss: {train_loss:.4f}")
            logging.info("epoch %d: %d steps in %.1fs (%.2f steps/s)",
                         epoch + 1, steps, dt, steps / dt if dt > 0 else 0.0)

            self._checkpoint({"epoch": epoch + 1, "global_step": global_step,
                              "plateau": {
                                  "best": plateau.best,
                                  "num_bad_epochs": plateau.num_bad_epochs,
                                  "scale": plateau.scale}})
            if save_sound_outputs and vocoder is not None and writer:
                from ..eval.synthesis import save_output

                save_output(self, devset[0], os.path.join(
                    cfg.output_directory, f"epoch_{epoch}_output.wav"),
                    devset.mfcc_norm, vocoder)
        return self.model

    def eval_groups(self, dataset, batch_size: int = 32) -> List[List[int]]:
        """Group eval examples to fit the fixed packed-batch capacity."""
        groups: List[List[int]] = []
        cur: List[int] = []
        cur_frames = 0
        cap = self.frames_cap if self.data_cfg.fixed_shapes else None
        for i in range(len(dataset)):
            frames = dataset[i]["emg"].shape[0]
            over_cap = cap is not None and cur and \
                cur_frames + frames > cap
            if len(cur) >= batch_size or over_cap:
                groups.append(cur)
                cur, cur_frames = [], 0
            cur.append(i)
            cur_frames += frames
        if cur:
            groups.append(cur)
        return groups

    def evaluate(self, dataset, batch_size: int = 32,
                 model: Optional[Forward] = None
                 ) -> Tuple[float, float, np.ndarray]:
        """Validation loss, phoneme accuracy and the (48, 48) confusion
        matrix (reference ``transduction_model.py:33-55``); the sums stay
        on the device until the last group. ``model`` as in
        ``eval_step``."""
        if self.model is None and model is None:
            raise RuntimeError("call fit() or init_state() first")
        losses, correct, total = [], 0, 0
        confusion = torch.zeros((NUM_PHONES, NUM_PHONES),
                                device=self.device)
        for group in self.eval_groups(dataset, batch_size):
            out = self.eval_step(self._pack([dataset[i] for i in group]),
                                 model)
            losses.append(out.loss)
            correct = correct + out.correct_phones
            total = total + out.total_length
            confusion += out.confusion
        if not losses:
            return 0.0, 0.0, confusion.cpu().double().numpy()
        mean_loss = float(torch.stack(losses).cpu().double().sum()) \
            / len(losses)
        acc = int(correct) / max(int(total), 1)
        return mean_loss, acc, confusion.cpu().double().numpy()

    # ---------------- inference ---------------------------------------
    def predict(self, example: dict) -> np.ndarray:
        """(T, 80) normalized mel prediction for one utterance, the padding
        masked out of attention by the utterance's length."""
        (pred, _), t = self._forward_single(example)
        return pred[0, :t].cpu().numpy()

    def get_aligned_prediction(self, example: dict, audio_normalizer
                               ) -> np.ndarray:
        """The prediction, DTW-warped onto the voiced target's timeline for
        a silent utterance, denormalized (reference
        ``transduction_model.py:75-96``): the vocoder's fine-tuning data."""
        return aligned_prediction(self.predict(example), example,
                                  audio_normalizer, self.device)


def aligned_prediction(pred: np.ndarray, example: dict, audio_normalizer,
                       device: torch.device) -> np.ndarray:
    """``pred`` (T, 80), warped onto the voiced target of a silent
    ``example`` by DTW (a voiced one is left as it is), then denormalized.
    The f32 distances are the JAX trainer's numpy expression; the DTW runs
    on ``device`` (the kernel on the card, K = 1)."""
    if example["silent"]:
        y = np.asarray(example["parallel_voiced_audio_features"])
        costs = np.sqrt(np.clip(
            (pred ** 2).sum(-1)[:, None] + (y ** 2).sum(-1)[None, :]
            - 2 * pred @ y.T, 1e-12, None))
        lengths = [torch.tensor([n], dtype=torch.int32, device=device)
                   for n in (y.shape[0], pred.shape[0])]
        align, _ = dtw_align_batch(
            torch.from_numpy(np.ascontiguousarray(costs.T)).to(device)[None],
            *lengths)
        pred = pred[align[0].cpu().numpy()]
    return audio_normalizer.inverse(pred)
