"""EMG→mel transduction training: steps, the training run, inference.

Counterpart of ``TransductionTrainer`` in the JAX package
(``silent_speech_tpu/train/transduction.py``). A step takes either a batch
packed on the host (``train_step``) or the ids of utterances in a corpus on
the device (``train_step_ids``, whose batch is gathered there); each runs
the encoder forward with shift augmentation and dropout, the transduction
loss (DTW on the silent rows), the backward and the AdamW update, and
returns its loss, phoneme hits and target length as tensors on the device,
so consecutive steps queue without waiting for the card. ``fit`` runs
epochs of steps over a dataset with the warmup × plateau learning rate,
validates, writes ``log.txt`` lines, checkpoints and resumes; it reads the
step losses once an epoch. ``get_aligned_prediction`` warps one
utterance's prediction onto its voiced target through the DTW kernel.
Randomness (weights, shift, dropout seeds) comes from explicit CPU
``torch.Generator``s. It runs on ``cuda`` unless given ``device="cpu"``.

On a data × model mesh (``mesh=``, ``parallel/mesh.py``) each rank holds
its model rank's shard of the weights and moments; a step assembles the
whole batch on every rank (same ids, shift and dropout seeds from the
same generator), runs the training forward on the data rank's chunk
rows, gathers the predictions and phone logits over ``data`` (a gather
whose backward keeps the rank's slice) and computes the whole loss on
every rank, so utterances that cross a rank's chunk boundary need
nothing more; the gradients are summed over ``data`` once a step before
the update. The chunk and utterance buckets are rounded up to the data
axis, as JAX rounds them. Rank 0 alone writes ``log.txt`` lines and
files.

The JAX trainer's wave and scan steps amortize the dispatch to a remote
TPU and have no counterpart here.
"""

from __future__ import annotations

import logging
import os
import time
from typing import (Callable, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..config import DataConfig, ModelConfig, TransductionTrainConfig
from ..data.device_cache import (DeviceCorpus, assemble_batch,
                                 build_training_corpus)
from ..data.packing import (SILENT_BUCKET, DeviceBatch, PackedBatch,
                            pack_batch, upload)
from ..data.sampler import SizeAwareSampler
from ..models.encoder import EMGEncoder
from ..ops.dtw import dtw_align_batch
from ..phonemes import NUM_PHONES
from ..parallel.collectives import all_gather
from ..parallel.mesh import data_sync
from ..utils.device import (deterministic_cudnn, resolve_device,
                            step_precision)
from ..utils.profiling import span
from .checkpoint import (checkpoint_exists, export_reference_checkpoint,
                         is_writer, restore_checkpoint, save_checkpoint)
from .losses import TransductionLossOut, transduction_loss
from .schedule import ReduceLROnPlateau, warmup_lr
from .state import FusedAdamW

__all__ = ["DeviceBatch", "TransductionTrainer", "aligned_prediction",
           "upload"]

# an eval forward: raw EMG (B, 8T, C) → (mel (B, T, 80), phone logits)
Forward = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class TransductionTrainer:
    def __init__(self, model_cfg: Optional[ModelConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 train_cfg: Optional[TransductionTrainConfig] = None,
                 num_mel_bins: int = 80,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        self.model_cfg = model_cfg or ModelConfig()
        self.data_cfg = data_cfg or DataConfig()
        self.train_cfg = train_cfg or TransductionTrainConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.dtype = getattr(torch, self.model_cfg.compute_dtype)
        self.num_mel_bins = num_mel_bins
        self.model: Optional[EMGEncoder] = None
        self.optimizer: Optional[FusedAdamW] = None
        self.generator: Optional[torch.Generator] = None

    def init_state(self, seed: int = 0) -> EMGEncoder:
        """Random weights from ``seed``, zeroed AdamW moments, and the
        step generator (shift and dropout draws) from ``seed + 1``. With
        ``start_training_from``, the weights of that reference-layout
        ``model.pt`` that match are loaded over the random ones (the
        reference's ``strict=False``, ``transduction_model.py:171-173``)."""
        model = EMGEncoder(self.num_mel_bins, NUM_PHONES, self.model_cfg)
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
            grad_sync=None if self.mesh is None else data_sync(self.mesh))
        self.generator = torch.Generator().manual_seed(seed + 1)
        return self.model

    @property
    def frames_cap(self) -> int:
        """Packed feature frames implied by the raw-sample batch capacity
        (1 kHz capture → 516.79 Hz → frame hop 6, reference
        ``read_emg.py:70-88``)."""
        return int(self.train_cfg.max_batch_len * (516.79 / 1000.0) / 6.0)

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
                          fixed_chunks=fixed_chunks, fixed_utts=fixed_utts,
                          fixed_t=fixed_t)

    # ---------------- steps -------------------------------------------
    def _loss(self, db: DeviceBatch, n_silent: Optional[int], train: bool,
              model: Optional[Forward] = None, **kwargs
              ) -> TransductionLossOut:
        if model is None:
            raw = db.raw_emg
            if train and self.mesh is not None:
                first, count = self.mesh.rows(raw.shape[0])
                raw = raw[first: first + count]
            pred, phone = self.model(raw, train=train,
                                     generator=self.generator)
            if train and self.mesh is not None:
                group = self.mesh.data_group
                pred, phone = (all_gather(x, group, 0, "slice")
                               for x in (pred, phone))
        else:
            pred, phone = model(db.raw_emg)
        with span("ssp.loss"):
            return transduction_loss(
                pred, phone, db, self.train_cfg.phoneme_loss_weight,
                n_silent=n_silent, **kwargs)

    def _step(self, db: DeviceBatch, n_silent: Optional[int], lr: float
              ) -> TransductionLossOut:
        if self.model is None:
            raise RuntimeError("call init_state() before a training step")
        for p in self.model.parameters():
            p.grad = None
        # deterministic convolutions: two steps from one state on one
        # batch give bit-equal gradients on the card, as in JAX; a float32
        # step with TF32 off
        with deterministic_cudnn(), step_precision(self.dtype):
            out = self._loss(db, n_silent, True, matmul_dtype=self.dtype)
            with span("ssp.backward"):
                out.loss.backward()
        self.optimizer.step(lr)
        return out._replace(loss=out.loss.detach())

    def train_step(self, batch: PackedBatch, lr: float
                   ) -> TransductionLossOut:
        """One optimizer step on ``batch`` at learning rate ``lr``. Each
        parameter's ``.grad`` holds this step's gradient afterwards."""
        return self._step(upload(batch, self.device), batch.num_silent, lr)

    def _cache_caps(self) -> dict:
        """The fixed shapes of a batch gathered on the device, the same as
        ``_pack``'s."""
        d = self.data_cfg
        cb = _round_up(d.chunk_bucket, self.data_parallel)
        return dict(n_chunks=_round_up(-(-self.frames_cap // d.seq_len) + 2,
                                       cb),
                    seq_len=d.seq_len, t_cap=d.t_cap, text_cap=128)

    @staticmethod
    def _cache_guard_ok(corpus: DeviceCorpus, ids: List[int], caps: dict,
                        u_cap: int) -> bool:
        """True when a batch fits the caps of on-device assembly."""
        return not (
            len(ids) > u_cap
            or int(corpus.feat_len_host[ids].sum())
            > caps["n_chunks"] * caps["seq_len"]
            or int(corpus.feat_len_host[ids].max(initial=0)) > caps["t_cap"]
            or int(corpus.tgt_len_host[ids].max(initial=0)) > caps["t_cap"]
            or int(corpus.text_len_host[ids].max(initial=0))
            > caps["text_cap"])

    def _cache_fits(self, corpus: DeviceCorpus, ids: Sequence[int]) -> bool:
        return self._cache_guard_ok(corpus, list(ids), self._cache_caps(),
                                    self.utt_cap)

    def train_step_ids(self, corpus: DeviceCorpus, ids: Sequence[int],
                       lr: float) -> Optional[TransductionLossOut]:
        """One optimizer step on the corpus utterances ``ids``: their batch
        is gathered on the device (``assemble_batch``), equal to
        ``_pack`` of the same examples. Returns None, and steps nothing,
        when the batch exceeds the fixed caps; the caller then packs it on
        the host. Only the (U,) id vector crosses to the device."""
        with span("ssp.step"):
            caps = self._cache_caps()
            u_cap = self.utt_cap
            ids = corpus.order_silent_first(ids)
            if not self._cache_guard_ok(corpus, ids, caps, u_cap):
                return None
            n_sil = int(corpus.silent_mask[ids].sum())
            n_silent = min(_round_up(n_sil, SILENT_BUCKET), u_cap) \
                if n_sil else 0
            with span("ssp.assemble"):
                utt_ids = torch.zeros(u_cap, dtype=torch.int64)
                utt_ids[: len(ids)] = torch.as_tensor(ids, dtype=torch.int64)
                if self.device.type == "cuda":
                    # from pinned memory the copy queues without waiting
                    # for the steps before it
                    utt_ids = utt_ids.pin_memory()
                utt_ids = utt_ids.to(self.device, non_blocking=True)
                valid = torch.arange(u_cap, device=self.device) < len(ids)
                db = assemble_batch(corpus.arrays, utt_ids, valid,
                                    n_chunks=caps["n_chunks"],
                                    seq_len=caps["seq_len"],
                                    t_cap=caps["t_cap"])
            return self._step(db, n_silent, lr)

    @torch.no_grad()
    def eval_step(self, batch: PackedBatch, model: Optional[Forward] = None
                  ) -> TransductionLossOut:
        """The eval forward and the loss in float32, with the phoneme
        confusion matrix. ``model`` maps the raw EMG to the two heads in
        place of the trainer's model (an ensemble's mean)."""
        if self.model is None and model is None:
            raise RuntimeError("call init_state() before eval_step()")
        return self._loss(upload(batch, self.device), batch.num_silent,
                          False, model, phoneme_eval=True)

    # ---------------- the training run --------------------------------
    def batches(self, dataset, max_len: Optional[int] = None,
                seed: Optional[int] = None) -> Iterable[PackedBatch]:
        sampler = SizeAwareSampler(
            dataset, max_len or self.train_cfg.max_batch_len, seed=seed)
        for idx_batch in sampler:
            yield self._pack([dataset[i] for i in idx_batch])

    def build_corpus(self, dataset) -> Optional[DeviceCorpus]:
        """``dataset`` as a ``DeviceCorpus``, or None when the corpus is off
        or over its budget (then training packs on the host)."""
        return build_training_corpus(dataset, self.data_cfg, self.device)

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
            losses = []
            t0 = time.time()
            for idx_batch in sampler:
                lr = float(np.float32(
                    warmup_lr(global_step, cfg.learning_rate,
                              cfg.learning_rate_warmup) * plateau.scale))
                out = None
                if corpus is not None:
                    out = self.train_step_ids(corpus, idx_batch, lr)
                if out is None:  # no corpus, or over its caps: host path
                    out = self.train_step(
                        self._pack([trainset[i] for i in idx_batch]), lr)
                losses.append(out.loss)
                global_step += 1
            step_losses = (torch.stack(losses).cpu().double().numpy()
                           if losses else np.zeros(0))
            train_loss = float(np.mean(step_losses)) if losses \
                else float("nan")
            dt = time.time() - t0
            if losses and not np.isfinite(train_loss):
                logging.error("non-finite training loss at epoch %d - "
                              "stopping (checkpoint from the previous "
                              "epoch is intact)", epoch + 1)
                raise FloatingPointError("non-finite training loss")

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
                         epoch + 1, len(losses), dt,
                         len(losses) / dt if dt > 0 else 0.0)

            save_checkpoint(
                cfg.output_directory, self,
                extra={"epoch": epoch + 1, "global_step": global_step,
                       "plateau": {"best": plateau.best,
                                   "num_bad_epochs": plateau.num_bad_epochs,
                                   "scale": plateau.scale}})
            export_reference_checkpoint(
                self.model, os.path.join(cfg.output_directory, "model.pt"))
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
    @staticmethod
    def pad_single(example: dict) -> Tuple[np.ndarray, int]:
        """The raw EMG of one utterance zero-padded to
        ``round_up(max(T, 8), 32)`` frames, as (1, 8·T_pad, C), and T: the
        JAX trainer's padding, so that the two forwards agree (a padded
        forward differs from an unpadded one at the last frames)."""
        t = example["emg"].shape[0]
        t_pad = _round_up(max(t, 8), 32)
        raw = np.zeros((1, t_pad * 8, example["raw_emg"].shape[1]),
                       np.float32)
        raw[0, : t * 8] = example["raw_emg"]
        return raw, t

    @torch.no_grad()
    def predict(self, example: dict) -> np.ndarray:
        """(T, 80) normalized mel prediction for one utterance, the padding
        masked out of attention by the utterance's length."""
        if self.model is None:
            raise RuntimeError("call fit() or init_state() first")
        raw, t = self.pad_single(example)
        pred, _ = self.model(torch.from_numpy(raw).to(self.device),
                             valid_len=t)
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
