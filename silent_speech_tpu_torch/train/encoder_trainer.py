"""The training core both EMG trainers share: what a batch on the card
looks like, and how a micro-step runs it.

``EncoderTrainer`` holds the encoder, its ``FusedAdamW`` and the step
generator, and owns the decisions that ``TransductionTrainer`` and
``RecognitionTrainer`` would otherwise each repeat: the fixed shapes of a
batch (the caps, from ``max_batch_len``, ``seq_len``, ``t_cap`` and the
128-character text cap), packing on the host and the guard of assembly on
the device, the gathered batch with its pinned id upload, the training
forward on a data × model mesh, the micro-step's scopes and spans, an
epoch's steps, the checkpoint, and the padding of one utterance for
inference. A subclass gives the encoder's heads, whether its batches carry
the voiced audio (``WITH_AUDIO``, which also decides whether the guard
checks the target lengths), its optimizer's ``grad_accum``, and its loss.

On a mesh (``mesh=``, ``parallel/mesh.py``) each rank holds its model
rank's shard of the weights and moments; a step assembles the whole batch
on every rank (same ids, shift and dropout seeds from the same generator),
runs the training forward on the data rank's chunk rows, gathers each
output over ``data`` (a gather whose backward keeps the rank's slice) and
computes the whole loss on every rank, so utterances that cross a rank's
chunk boundary need nothing more; the optimizer sums the gradients over
``data`` before an update. The chunk and utterance buckets are rounded up
to the data axis, as JAX rounds them.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..config import DataConfig, ModelConfig
from ..data.device_cache import (DeviceCorpus, assemble_batch,
                                 build_training_corpus)
from ..data.packing import (SILENT_BUCKET, DeviceBatch, PackedBatch,
                            pack_batch, upload)
from ..models.encoder import EMGEncoder
from ..parallel.collectives import all_gather
from ..parallel.mesh import data_sync
from ..utils.device import (deterministic_cudnn, resolve_device,
                            step_precision)
from ..utils.profiling import span
from .checkpoint import export_reference_checkpoint, save_checkpoint
from .schedule import warmup_lr
from .state import FusedAdamW

TEXT_CAP = 128   # characters an utterance may have on the device path


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class EncoderTrainer:
    WITH_AUDIO: bool   # whether a batch carries the voiced audio targets

    def __init__(self, model_cfg: Optional[ModelConfig],
                 data_cfg: Optional[DataConfig], train_cfg,
                 device: Optional[Union[str, torch.device]], mesh):
        self.model_cfg = model_cfg or ModelConfig()
        self.data_cfg = data_cfg or DataConfig()
        self.train_cfg = train_cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.dtype = getattr(torch, self.model_cfg.compute_dtype)
        self.model: Optional[EMGEncoder] = None
        self.optimizer: Optional[FusedAdamW] = None
        self.generator: Optional[torch.Generator] = None

    # ---------------- what a subclass gives ---------------------------
    def _heads(self) -> Tuple[int, Optional[int]]:
        """The encoder's ``num_outs`` and ``num_aux_outs``."""
        raise NotImplementedError

    def _grad_accum(self) -> int:
        """Micro-steps an optimizer update averages."""
        return 1

    def _train_loss(self, out, db: DeviceBatch, n_silent: int
                    ) -> Tuple[torch.Tensor, Any]:
        """The loss to differentiate, from the training forward's ``out``
        on ``db``, and what a step returns with that loss detached."""
        raise NotImplementedError

    @staticmethod
    def _step_loss(result) -> torch.Tensor:
        """The loss, on the device, of what a step returned."""
        raise NotImplementedError

    # ---------------- state -------------------------------------------
    def init_state(self, seed: int = 0) -> EMGEncoder:
        """Random weights from ``seed``, zeroed AdamW moments (and
        accumulator), and the step generator (shift and dropout draws)
        from ``seed + 1``. With ``start_training_from``, the weights of
        that reference-layout ``model.pt`` that match are loaded over the
        random ones (the reference's ``strict=False``,
        ``transduction_model.py:171-173``)."""
        model = EMGEncoder(*self._heads(), self.model_cfg)
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
            grad_accum=self._grad_accum(),
            grad_sync=None if self.mesh is None else data_sync(self.mesh))
        self.generator = torch.Generator().manual_seed(seed + 1)
        return self.model

    # ---------------- batches -----------------------------------------
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

    def _cache_caps(self) -> dict:
        """The fixed shapes of a batch, packed or gathered: the frames of
        ``max_batch_len`` raw samples in chunks, plus 2, rounded up to the
        chunk bucket (64 chunks of 200 frames at the defaults)."""
        d = self.data_cfg
        cb = _round_up(d.chunk_bucket, self.data_parallel)
        return dict(n_chunks=_round_up(-(-self.frames_cap // d.seq_len) + 2,
                                       cb),
                    seq_len=d.seq_len, t_cap=d.t_cap, text_cap=TEXT_CAP)

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
                          with_audio=self.WITH_AUDIO,
                          fixed_chunks=fixed_chunks, fixed_utts=fixed_utts,
                          fixed_t=fixed_t)

    def _cache_fits(self, corpus: DeviceCorpus, ids: Sequence[int]) -> bool:
        """True when a batch fits the caps of on-device assembly; with
        audio, its voiced targets must fit ``t_cap`` too."""
        caps, ids = self._cache_caps(), list(ids)
        return not (
            len(ids) > self.utt_cap
            or int(corpus.feat_len_host[ids].sum())
            > caps["n_chunks"] * caps["seq_len"]
            or int(corpus.feat_len_host[ids].max(initial=0)) > caps["t_cap"]
            or (self.WITH_AUDIO and int(corpus.tgt_len_host[ids].max(
                initial=0)) > caps["t_cap"])
            or int(corpus.text_len_host[ids].max(initial=0))
            > caps["text_cap"])

    def build_corpus(self, dataset) -> Optional[DeviceCorpus]:
        """``dataset`` as a ``DeviceCorpus``, or None when the corpus is off
        or over its budget (then training packs on the host)."""
        return build_training_corpus(dataset, self.data_cfg, self.device)

    def assemble(self, corpus: DeviceCorpus, ids: Sequence[int]
                 ) -> DeviceBatch:
        """The batch of the corpus utterances ``ids`` (silent first)
        gathered on the device (``assemble_batch``), equal to ``_pack`` of
        the same examples. Only the (U,) id vector crosses to the
        device."""
        caps, u_cap = self._cache_caps(), self.utt_cap
        with span("ssp.assemble"):
            utt_ids = torch.zeros(u_cap, dtype=torch.int64)
            utt_ids[: len(ids)] = torch.as_tensor(ids, dtype=torch.int64)
            if self.device.type == "cuda":
                # from pinned memory the copy queues without waiting for
                # the steps before it
                utt_ids = utt_ids.pin_memory()
            utt_ids = utt_ids.to(self.device, non_blocking=True)
            valid = torch.arange(u_cap, device=self.device) < len(ids)
            return assemble_batch(corpus.arrays, utt_ids, valid,
                                  with_audio=self.WITH_AUDIO, **caps)

    # ---------------- steps -------------------------------------------
    def _train_forward(self, raw: torch.Tensor):
        """The training forward on ``raw``; on a mesh, on the data rank's
        rows, each output gathered over ``data``."""
        mesh = self.mesh
        if mesh is not None:
            first, count = mesh.rows(raw.shape[0])
            raw = raw[first: first + count]
        out = self.model(raw, train=True, generator=self.generator)
        if mesh is None:
            return out
        return tree_map(lambda x: all_gather(x, mesh.data_group, 0, "slice"),
                        out)

    def _step(self, db: DeviceBatch, n_silent: int, lr: float):
        if self.model is None:
            raise RuntimeError("call init_state() before a training step")
        for p in self.model.parameters():
            p.grad = None
        # deterministic convolutions: two steps from one state on one
        # batch give bit-equal gradients on the card, as in JAX; a float32
        # step with TF32 off
        with deterministic_cudnn(), step_precision(self.dtype):
            out = self._train_forward(db.raw_emg)
            with span("ssp.loss"):
                loss, result = self._train_loss(out, db, n_silent)
            del out   # autograd keeps what the backward needs of the heads
            with span("ssp.backward"):
                loss.backward()
        self.optimizer.step(lr)
        return result

    def train_step(self, batch: PackedBatch, lr: float):
        """One micro-step on ``batch`` at learning rate ``lr``. Each
        parameter's ``.grad`` holds this micro-step's gradient
        afterwards."""
        return self._step(upload(batch, self.device), batch.num_silent, lr)

    def train_step_ids(self, corpus: DeviceCorpus, ids: Sequence[int],
                       lr: float):
        """One micro-step on the corpus utterances ``ids``, their batch
        gathered on the device (``assemble``). Returns None, and steps
        nothing, when the batch exceeds the fixed caps; the caller then
        packs it on the host."""
        with span("ssp.step"):
            ids = corpus.order_silent_first(ids)
            if not self._cache_fits(corpus, ids):
                return None
            n_sil = int(corpus.silent_mask[ids].sum())
            n_silent = min(_round_up(n_sil, SILENT_BUCKET), self.utt_cap) \
                if n_sil else 0
            return self._step(self.assemble(corpus, ids), n_silent, lr)

    # ---------------- the training run --------------------------------
    def _train_epoch(self, epoch: int, trainset, sampler,
                     corpus: Optional[DeviceCorpus], global_step: int,
                     lr_scale: float) -> Tuple[float, int]:
        """One epoch's steps over ``sampler``'s batches, from step
        ``global_step``: each at the warmup learning rate times
        ``lr_scale``, on ``corpus`` when it has the batch within its caps,
        else packed on the host. The step losses stay on the device and
        are read once, at the end: returns their mean and the step count.
        A non-finite mean raises ``FloatingPointError``."""
        cfg = self.train_cfg
        losses = []
        for idx_batch in sampler:
            lr = float(np.float32(
                warmup_lr(global_step + len(losses), cfg.learning_rate,
                          cfg.learning_rate_warmup) * lr_scale))
            out = None
            if corpus is not None:
                out = self.train_step_ids(corpus, idx_batch, lr)
            if out is None:  # no corpus, or over its caps: host path
                out = self.train_step(
                    self._pack([trainset[i] for i in idx_batch]), lr)
            losses.append(self._step_loss(out))
        if not losses:
            return float("nan"), 0
        train_loss = float(np.mean(torch.stack(losses).cpu().double()
                                   .numpy()))
        if not np.isfinite(train_loss):
            logging.error("non-finite training loss at epoch %d - stopping "
                          "(checkpoint from the previous epoch is intact)",
                          epoch + 1)
            raise FloatingPointError("non-finite training loss")
        return train_loss, len(losses)

    def _checkpoint(self, extra: dict) -> None:
        """The checkpoint and the reference-layout ``model.pt`` in
        ``train_cfg.output_directory``."""
        out_dir = self.train_cfg.output_directory
        save_checkpoint(out_dir, self, extra=extra)
        export_reference_checkpoint(self.model,
                                    os.path.join(out_dir, "model.pt"))

    # ---------------- inference ---------------------------------------
    @staticmethod
    def pad_single(example: dict, t_pad: Optional[int] = None
                   ) -> Tuple[np.ndarray, int]:
        """The raw EMG of one utterance zero-padded to ``t_pad`` frames
        (default ``round_up(max(T, 8), 32)``, the JAX trainers' padding,
        so that the two forwards agree: a padded forward differs from an
        unpadded one at the last frames), as (1, 8·t_pad, C), and T."""
        t = example["emg"].shape[0]
        if t_pad is None:
            t_pad = _round_up(max(t, 8), 32)
        raw = np.zeros((1, t_pad * 8, example["raw_emg"].shape[1]),
                       np.float32)
        raw[0, : t * 8] = example["raw_emg"]
        return raw, t

    @torch.no_grad()
    def _forward_single(self, example: dict, t_pad: Optional[int] = None):
        """The eval forward of one utterance padded by ``pad_single``, the
        padding masked out of attention by its length; and T."""
        if self.model is None:
            raise RuntimeError("call fit() or init_state() first")
        raw, t = self.pad_single(example, t_pad)
        return self.model(torch.from_numpy(raw).to(self.device),
                          valid_len=t), t
