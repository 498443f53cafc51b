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

On a data × model mesh (``mesh=``) a micro-step runs as the transduction
trainer's does: the forward on the data rank's chunk rows, the logits
gathered over ``data``, the whole CTC loss on every rank; the gradient is
summed over ``data`` once an update, on the accumulated mean. The chunk
and utterance buckets are rounded up to the data axis.

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
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import DataConfig, ModelConfig, RecognitionTrainConfig
from ..data.device_cache import (DeviceCorpus, assemble_batch,
                                 build_training_corpus)
from ..data.packing import DeviceBatch, PackedBatch, pack_batch, upload
from ..data.sampler import SizeAwareSampler
from ..eval.decode import (beam_ctc_decode, greedy_ctc_decode,
                           native_beam_usable)
from ..models.encoder import EMGEncoder
from ..text import TextTransform, wer
from ..parallel.collectives import all_gather
from ..parallel.mesh import data_sync
from ..utils.device import (deterministic_cudnn, resolve_device,
                            step_precision)
from ..utils.profiling import span
from .checkpoint import (checkpoint_exists, export_reference_checkpoint,
                         restore_checkpoint, save_checkpoint)
from .losses import ctc_loss
from .schedule import MultiStepLR, warmup_lr
from .state import FusedAdamW

TEXT_CAP = 128   # characters an utterance may have on the device path


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class RecognitionTrainer:
    def __init__(self, model_cfg: Optional[ModelConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 train_cfg: Optional[RecognitionTrainConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        self.model_cfg = model_cfg or ModelConfig()
        self.data_cfg = data_cfg or DataConfig()
        self.train_cfg = train_cfg or RecognitionTrainConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.text_transform = TextTransform()
        # blank = the index after the last character
        # (reference recognition_model.py:33)
        self.blank_id = len(self.text_transform.chars)
        self.model: Optional[EMGEncoder] = None
        self.optimizer: Optional[FusedAdamW] = None
        self.generator: Optional[torch.Generator] = None
        self._lm = None
        self._warned_no_lm = False

    def init_state(self, seed: int = 0) -> EMGEncoder:
        """Random weights from ``seed``, zeroed AdamW moments and
        accumulator, and the step generator from ``seed + 1``. With
        ``start_training_from``, the weights of that reference-layout
        ``model.pt`` that match are loaded over the random ones."""
        model = EMGEncoder(self.blank_id + 1, None, self.model_cfg)
        model.init_weights(torch.Generator().manual_seed(seed))
        if self.train_cfg.start_training_from:
            model.load_state_dict(torch.load(
                self.train_cfg.start_training_from, map_location="cpu",
                weights_only=True), strict=False)
        if self.mesh is not None:
            model.shard(self.mesh)
        self.model = model.to(self.device)
        self.optimizer = FusedAdamW(
            self.model.parameters(), weight_decay=self.train_cfg.l2,
            moment_dtype=getattr(torch, self.train_cfg.moment_dtype),
            grad_accum=self.train_cfg.grad_accum,
            grad_sync=None if self.mesh is None else data_sync(self.mesh))
        self.generator = torch.Generator().manual_seed(seed + 1)
        return self.model

    # ---------------- batches -----------------------------------------
    def _cache_caps(self) -> dict:
        """The fixed shapes of a batch, packed or gathered: the frames of
        ``max_batch_len`` raw samples in chunks, plus 2, rounded up to the
        chunk bucket (64 chunks of 200 frames at the defaults)."""
        d = self.data_cfg
        frames_cap = int(self.train_cfg.max_batch_len * (516.79 / 1000.0)
                         / 6.0)
        cb = _round_up(d.chunk_bucket, self.data_parallel)
        return dict(n_chunks=_round_up(-(-frames_cap // d.seq_len) + 2, cb),
                    seq_len=d.seq_len, t_cap=d.t_cap, text_cap=TEXT_CAP)

    @property
    def data_parallel(self) -> int:
        return 1 if self.mesh is None else self.mesh.data_parallel

    @property
    def utt_cap(self) -> int:
        return _round_up(self.data_cfg.utt_cap, self.data_parallel)

    def _pack(self, examples: List[dict]) -> PackedBatch:
        d, dp = self.data_cfg, self.data_parallel
        fixed_chunks = fixed_utts = fixed_t = None
        if d.fixed_shapes:
            fixed_t = d.t_cap
            fixed_utts = self.utt_cap
            fixed_chunks = self._cache_caps()["n_chunks"]
        return pack_batch(examples, seq_len=d.seq_len,
                          chunk_bucket=_round_up(d.chunk_bucket, dp),
                          utt_bucket=_round_up(8, dp),
                          with_audio=False, fixed_chunks=fixed_chunks,
                          fixed_utts=fixed_utts, fixed_t=fixed_t)

    def _cache_fits(self, corpus: DeviceCorpus, ids: Sequence[int]) -> bool:
        """True when a batch fits the caps of on-device assembly."""
        caps, ids = self._cache_caps(), list(ids)
        return not (
            len(ids) > self.utt_cap
            or int(corpus.feat_len_host[ids].sum())
            > caps["n_chunks"] * caps["seq_len"]
            or int(corpus.feat_len_host[ids].max(initial=0)) > caps["t_cap"]
            or int(corpus.text_len_host[ids].max(initial=0))
            > caps["text_cap"])

    def build_corpus(self, dataset) -> Optional[DeviceCorpus]:
        return build_training_corpus(dataset, self.data_cfg, self.device)

    # ---------------- steps -------------------------------------------
    def _step(self, db: DeviceBatch, lr: float) -> torch.Tensor:
        if self.model is None:
            raise RuntimeError("call init_state() before a training step")
        for p in self.model.parameters():
            p.grad = None
        with deterministic_cudnn(), \
                step_precision(self.model.compute_dtype):
            raw = db.raw_emg
            if self.mesh is not None:
                first, count = self.mesh.rows(raw.shape[0])
                raw = raw[first: first + count]
            logits = self.model(raw, train=True, generator=self.generator)
            if self.mesh is not None:
                logits = all_gather(logits, self.mesh.data_group, 0, "slice")
            with span("ssp.loss"):
                loss = ctc_loss(torch.log_softmax(logits, dim=-1), db,
                                self.blank_id)
            with span("ssp.backward"):
                loss.backward()
        self.optimizer.step(lr)
        return loss.detach()

    def train_step(self, batch: PackedBatch, lr: float) -> torch.Tensor:
        """One micro-step on ``batch`` at learning rate ``lr``; returns the
        loss on the device. Each parameter's ``.grad`` holds this
        micro-step's gradient afterwards."""
        return self._step(upload(batch, self.device), lr)

    def train_step_ids(self, corpus: DeviceCorpus, ids: Sequence[int],
                       lr: float) -> Optional[torch.Tensor]:
        """One micro-step on the corpus utterances ``ids``, their batch
        gathered on the device, equal to ``_pack`` of the same examples.
        Returns None, and steps nothing, when the batch exceeds the fixed
        caps; the caller then packs it on the host."""
        with span("ssp.step"):
            if not self._cache_fits(corpus, ids):
                return None
            caps, u_cap = self._cache_caps(), self.utt_cap
            ids = corpus.order_silent_first(ids)
            with span("ssp.assemble"):
                utt_ids = torch.zeros(u_cap, dtype=torch.int64)
                utt_ids[: len(ids)] = torch.as_tensor(ids, dtype=torch.int64)
                if self.device.type == "cuda":
                    utt_ids = utt_ids.pin_memory()
                utt_ids = utt_ids.to(self.device, non_blocking=True)
                valid = torch.arange(u_cap, device=self.device) < len(ids)
                db = assemble_batch(corpus.arrays, utt_ids, valid,
                                    with_audio=False, **caps)
            return self._step(db, lr)

    # ---------------- inference ---------------------------------------
    @torch.no_grad()
    def _log_probs(self, example: dict, t_pad: int) -> torch.Tensor:
        """(T, 38) log-probs of one utterance zero-padded to ``t_pad``
        frames, the padding masked out of attention, on the device."""
        t = example["emg"].shape[0]
        raw = np.zeros((1, t_pad * 8, example["raw_emg"].shape[1]),
                       np.float32)
        raw[0, : t * 8] = example["raw_emg"]
        out = self.model(torch.from_numpy(raw).to(self.device), valid_len=t)
        return torch.log_softmax(out[0, :t], dim=-1)

    def predict_logits(self, example: dict) -> np.ndarray:
        """(T, 38) log-probs of one utterance, padded as the JAX trainer
        pads it (``round_up(max(T, 8), 32)`` frames)."""
        if self.model is None:
            raise RuntimeError("call fit() or init_state() first")
        t = example["emg"].shape[0]
        return self._log_probs(example, _round_up(max(t, 8), 32)).cpu(
            ).numpy()

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
            losses = []
            t0 = time.time()
            for idx_batch in sampler:
                # warmup counts micro-steps, as the reference counts batches
                lr = float(np.float32(
                    warmup_lr(global_step, cfg.learning_rate,
                              cfg.learning_rate_warmup) * multistep.scale))
                loss = None
                if corpus is not None:
                    loss = self.train_step_ids(corpus, idx_batch, lr)
                if loss is None:  # no corpus, or over its caps: host path
                    loss = self.train_step(
                        self._pack([trainset[i] for i in idx_batch]), lr)
                losses.append(loss)
                global_step += 1
            step_losses = (torch.stack(losses).cpu().double().numpy()
                           if losses else np.zeros(0))
            train_loss = float(np.mean(step_losses)) if losses \
                else float("nan")
            if losses and not np.isfinite(train_loss):
                logging.error("non-finite training loss at epoch %d - "
                              "stopping (checkpoint from the previous "
                              "epoch is intact)", epoch + 1)
                raise FloatingPointError("non-finite training loss")
            val_wer = self.evaluate_wer(devset)
            logging.info(f"finished epoch {epoch + 1} - training loss: "
                         f"{train_loss:.4f} validation WER: "
                         f"{val_wer * 100:.2f}")
            multistep.step()
            logging.info("epoch %d took %.1fs", epoch + 1, time.time() - t0)
            save_checkpoint(
                cfg.output_directory, self,
                extra={"epoch": epoch + 1, "global_step": global_step,
                       "lr_scale": multistep.scale})
            export_reference_checkpoint(
                self.model, os.path.join(cfg.output_directory, "model.pt"))
        return self.model
