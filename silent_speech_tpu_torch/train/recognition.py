"""EMG→text recognition training: CTC steps with gradient accumulation,
the training run, and validation WER through the LM-fused beam decoder.

Counterpart of ``RecognitionTrainer`` in the JAX package
(``silent_speech_tpu/train/recognition.py``; reference
``recognition_model.py:30-117``). The encoder has a 38-way head, the 37
characters and the CTC blank (37). A micro-step takes a batch packed on
the host (``train_step``) or the ids of utterances in a corpus on the
device (``train_step_ids``), runs the training forward (shift and dropout,
no length mask, so the attention kernel sees whole chunks), the CTC loss
(the port's kernel on optax's lattice) and the backward, with cuDNN's
deterministic convolutions, so a micro-step's gradient is bit-equal
between calls; and folds the gradient into the optimizer's accumulator;
every ``grad_accum``-th micro-step updates the weights
(``optax.MultiSteps`` in JAX). Warmup counts micro-steps, and a milestone
schedule halves the learning rate at epochs 125, 150 and 175. ``fit``
reads the step losses once an epoch, validates by beam-decoding the dev
set, writes the JAX ``log.txt`` lines, checkpoints (the accumulator
included) and resumes.

Validation keeps the JAX grouping (sort by length, groups of 16, each
padded to its longest utterance rounded up to 32 frames), but runs each
utterance alone at its group's padding with its own length as the
attention mask: the attention kernel takes one length a launch. Conv and
eval-mode BatchNorm act per row, so each row equals the JAX batched row,
the padding's effect on the last frames included.

The batches, the micro-step, an epoch's steps and the mesh are the shared
core's (``train/encoder_trainer.py``); batches here carry no audio. On a
data × model mesh (``mesh=``) the gradient is summed over ``data`` once an
update, on the accumulated mean.

The JAX trainer's wave and scan steps amortize the dispatch to a remote
TPU; the port's steps queue on the card without them, as the transduction
trainer's do, so they have no counterpart here. Randomness comes from
explicit CPU ``torch.Generator``s. It runs on ``cuda`` unless given
``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import DataConfig, ModelConfig, RecognitionTrainConfig
from ..data.packing import DeviceBatch
from ..data.sampler import SizeAwareSampler
from ..eval.decode import (beam_ctc_decode, greedy_ctc_decode,
                           native_beam_usable)
from ..models.encoder import EMGEncoder
from ..text import TextTransform, wer
from .checkpoint import checkpoint_exists, restore_checkpoint
from .encoder_trainer import EncoderTrainer, _round_up
from .losses import ctc_loss
from .schedule import MultiStepLR


class RecognitionTrainer(EncoderTrainer):
    WITH_AUDIO = False

    def __init__(self, model_cfg: Optional[ModelConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 train_cfg: Optional[RecognitionTrainConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        super().__init__(model_cfg, data_cfg,
                         train_cfg or RecognitionTrainConfig(), device, mesh)
        self.text_transform = TextTransform()
        # blank = the index after the last character
        # (reference recognition_model.py:33)
        self.blank_id = len(self.text_transform.chars)
        self._lm = None
        self._warned_no_lm = False

    def _heads(self) -> Tuple[int, Optional[int]]:
        return self.blank_id + 1, None

    def _grad_accum(self) -> int:
        return self.train_cfg.grad_accum

    # ---------------- steps -------------------------------------------
    def _train_loss(self, out, db: DeviceBatch, n_silent: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        loss = ctc_loss(torch.log_softmax(out, dim=-1), db, self.blank_id)
        return loss, loss.detach()

    @staticmethod
    def _step_loss(result: torch.Tensor) -> torch.Tensor:
        return result

    # ---------------- inference ---------------------------------------
    def _log_probs(self, example: dict, t_pad: Optional[int] = None
                   ) -> torch.Tensor:
        """(T, 38) log-probs of one utterance zero-padded to ``t_pad``
        frames (``pad_single``), the padding masked out of attention, on
        the device."""
        out, t = self._forward_single(example, t_pad)
        return torch.log_softmax(out[0, :t], dim=-1)

    def predict_logits(self, example: dict) -> np.ndarray:
        """(T, 38) log-probs of one utterance, padded as the JAX trainer
        pads it (``round_up(max(T, 8), 32)`` frames)."""
        return self._log_probs(example).cpu().numpy()

    def batch_logits(self, examples: List[dict], group: int = 16
                     ) -> List[np.ndarray]:
        """(T_i, 38) log-probs of each utterance in the padding of the JAX
        trainer's batched validation forward: sorted by length, in groups
        of ``group``, each padded to its longest rounded up to 32 frames.
        Read from the card once, at the end."""
        if self.model is None:
            raise RuntimeError("call fit() or init_state() first")
        order = sorted(range(len(examples)),
                       key=lambda i: examples[i]["emg"].shape[0])
        out: List[Optional[torch.Tensor]] = [None] * len(examples)
        for g in range(0, len(order), group):
            ids = order[g: g + group]
            t_pad = _round_up(max(examples[i]["emg"].shape[0]
                                  for i in ids), 32)
            for i in ids:
                out[i] = self._log_probs(examples[i], t_pad)
        return [lp.cpu().numpy() for lp in out]

    def _get_lm(self):
        """The beam decoder's LM: a KenLM probing binary or an ARPA file.
        A missing or unreadable file raises, except the default
        ``lm.binary`` when it does not exist: then the decode runs without
        an LM and says so once (as the JAX trainer does)."""
        cfg = self.train_cfg
        if self._lm is not None or not cfg.lm_path:
            return self._lm
        is_default = cfg.lm_path == RecognitionTrainConfig().lm_path
        if is_default and not os.path.exists(cfg.lm_path):
            if not self._warned_no_lm:
                logging.warning(
                    "language model %r not found - decoding WITHOUT an "
                    "LM; WER will not match the reference's LM-fused beam "
                    "search. Pass --lm_path to a KenLM probing .binary or "
                    "an ARPA file.", cfg.lm_path)
                self._warned_no_lm = True
            return None
        from ..eval.kenlm_binary import load_lm

        self._lm = load_lm(cfg.lm_path)
        logging.info("loaded %s LM from %s (order %d)",
                     type(self._lm).__name__, cfg.lm_path, self._lm.order)
        return self._lm

    def _transcript(self, lp: np.ndarray, beam: bool, lm) -> str:
        cfg = self.train_cfg
        if beam:
            ids = beam_ctc_decode(
                lp, self.text_transform.chars, self.blank_id,
                beam_width=cfg.beam_width, lm=lm, alpha=cfg.lm_alpha,
                beta=cfg.lm_beta)
        else:
            ids = greedy_ctc_decode(lp, self.blank_id)
        return self.text_transform.int_to_text(ids)

    def decode(self, example: dict, beam: bool = True) -> str:
        """The transcript of one utterance."""
        return self._transcript(self.predict_logits(example), beam,
                                self._get_lm() if beam else None)

    def transcripts(self, dataset, beam: bool = True) -> List[str]:
        """The transcripts of every utterance of ``dataset`` from
        ``batch_logits``; the native beam search decodes in a thread pool
        (its C call releases the GIL)."""
        examples = [dataset[i] for i in range(len(dataset))]
        all_lp = self.batch_logits(examples)
        lm = self._get_lm() if beam else None
        if beam and native_beam_usable(lm):
            workers = min(16, os.cpu_count() or 1, max(len(all_lp), 1))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                return list(pool.map(
                    lambda lp: self._transcript(lp, beam, lm), all_lp))
        return [self._transcript(lp, beam, lm) for lp in all_lp]

    def evaluate_wer(self, dataset, beam: bool = True) -> float:
        """Validation WER (reference ``recognition_model.py:30-58``)."""
        references = [self.text_transform.clean_text(dataset[i]["text"])
                      for i in range(len(dataset))]
        return wer(references, self.transcripts(dataset, beam))

    # ---------------- the training run --------------------------------
    def fit(self, trainset, devset, epochs: Optional[int] = None,
            seed: int = 0, resume: bool = False) -> EMGEncoder:
        """Train for ``epochs`` (default ``train_cfg.epochs``) over
        ``trainset``, any dataset with ``__len__``, ``__getitem__`` and
        ``example_meta``; after each epoch, validate (beam-decoded WER) on
        ``devset`` and checkpoint into ``train_cfg.output_directory``.
        ``resume=True`` restores the checkpoint there, accumulator
        included. As in JAX, a resumed run shuffles its first epoch as
        epoch 0. The step losses stay on the device and are read once an
        epoch; a non-finite epoch loss raises ``FloatingPointError``."""
        cfg = self.train_cfg
        epochs = epochs if epochs is not None else cfg.epochs
        os.makedirs(cfg.output_directory, exist_ok=True)
        multistep = MultiStepLR(milestones=cfg.lr_milestones,
                                gamma=cfg.lr_gamma)
        global_step = 0
        start_epoch = 0
        if self.model is None:
            self.init_state(seed)
        if resume and checkpoint_exists(cfg.output_directory):
            extra = restore_checkpoint(cfg.output_directory, self)
            global_step = int(extra.get("global_step", 0))
            start_epoch = int(extra.get("epoch", 0))
            multistep.epoch = start_epoch
            multistep.scale = float(extra.get("lr_scale", 1.0))
            logging.info("resumed from epoch %d (step %d)", start_epoch,
                         global_step)

        sampler = SizeAwareSampler(trainset, cfg.max_batch_len, seed=seed)
        corpus = self.build_corpus(trainset)

        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            # warmup counts micro-steps, as the reference counts batches
            train_loss, steps = self._train_epoch(
                epoch, trainset, sampler, corpus, global_step,
                multistep.scale)
            global_step += steps
            val_wer = self.evaluate_wer(devset)
            logging.info(f"finished epoch {epoch + 1} - training loss: "
                         f"{train_loss:.4f} validation WER: "
                         f"{val_wer * 100:.2f}")
            multistep.step()
            logging.info("epoch %d took %.1fs", epoch + 1, time.time() - t0)
            self._checkpoint({"epoch": epoch + 1, "global_step": global_step,
                              "lr_scale": multistep.scale})
        return self.model
