"""HiFi-GAN fine-tuning: the GAN step, its data and its checkpoints.

Counterpart of the JAX package's ``silent_speech_tpu/train/vocoder.py``.
The reference fine-tunes HiFi-GAN for 75k steps from UNIVERSAL_V1 on the
output of ``make_vocoder_trainset`` (aligned *predicted* mels and the gold
wavs, ``README.md:67-75``). The objective is the published one
(arXiv:2010.05646): LSGAN against the MPD + MSD ensemble, 2 × feature
matching and 45 × the L1 of log-mels, the generated audio's mel computed on
the device by ``dsp.mel.torch_log_mel_spectrogram``. Each step draws random
aligned segments (32 mel frames ↔ 8192 samples); both models train with
AdamW (β = (0.8, 0.99), ε = 1e-8, weight decay 0.01 on every tensor,
float32 moments, optax's arithmetic: ``train/state.FusedAdamW``) at
``2e-4 · 0.999^(step // steps_per_epoch)``.

A step updates the discriminators on the detached fake first, then the
generator against the updated discriminators; the generator's forward is
shared by both halves (its weights do not change in between), and the
generator half takes no discriminator weight gradients. Both halves run
under cuDNN's deterministic algorithms, so a resumed run repeats an
uninterrupted one bit for bit on the card. The full GAN state (both
models, both optimizers, the step) is one ``torch.save`` file, not orbax.

On a mesh (``mesh=``, ``parallel/mesh.py``), as in JAX, the GAN trains
data-parallel only: both models are replicated on every rank, each step's
segment batch (the same on every rank) is split over ``data`` and must
divide by it, and both updates of the step average their gradients over
``data``, since every loss is a mean over equal shards; the metrics are
averaged likewise. Rank 0 alone writes files.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..dsp.mel import MelConfig, log_mel_spectrogram, \
    torch_log_mel_spectrogram
from ..models.hifigan import (HiFiGANConfig, init_generator,
                              load_generator_state)
from ..models.hifigan_discriminators import (
    HiFiGANDiscriminators, discriminator_loss, feature_matching_loss,
    generator_adversarial_loss)
from ..utils.audio_io import read_audio
from ..parallel.collectives import all_reduce_
from ..parallel.mesh import barrier, data_sync
from ..utils.device import deterministic_cudnn, resolve_device
from .checkpoint import _atomic_save
from .state import FusedAdamW

SEGMENT_FRAMES = 32
STATE_FILE = "vocoder_state.pt"
METRICS = ("d_loss", "g_loss", "adv", "fm", "mel_l1")


class VocoderDataSource:
    """Aligned (mel, audio) segments from a ``make_vocoder_trainset``
    directory (``{prefix}_filelist.txt``, ``mels/{name}.npy`` (1, 80, T) and
    ``wavs/{name}.wav``) or from a plain directory of wav/flac files with
    gold mels. Segments are drawn by ``np.random.default_rng(seed)`` in the
    JAX source's order, so one seed gives the JAX source's segments."""

    def __init__(self, directory: str, prefix: str = "train",
                 hop: int = 256, seed: int = 0,
                 mel_cfg: Optional[MelConfig] = None):
        self.hop = hop
        self.mel_cfg = mel_cfg or MelConfig()
        if self.mel_cfg.hop_size != hop:
            raise ValueError(
                "gold-mel featurization must match the audio hop: "
                f"mel_cfg.hop_size={self.mel_cfg.hop_size} vs hop={hop}")
        self.items: List[Tuple[Optional[str], str]] = []
        filelist = os.path.join(directory, f"{prefix}_filelist.txt")
        if os.path.exists(filelist):
            with open(filelist) as f:
                names = [line.strip() for line in f if line.strip()]
            for name in names:
                self.items.append(
                    (os.path.join(directory, "mels", f"{name}.npy"),
                     os.path.join(directory, "wavs", f"{name}.wav")))
        else:  # a plain directory of audio; gold mels
            for name in sorted(os.listdir(directory)):
                if name.endswith((".wav", ".flac")):
                    self.items.append((None, os.path.join(directory, name)))
        if not self.items:
            raise ValueError(f"no vocoder training items in {directory}")
        self._rng = np.random.default_rng(seed)
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if idx not in self._cache:
            mel_path, wav_path = self.items[idx]
            audio, rate = read_audio(wav_path)
            if rate != 22050:
                raise ValueError(f"expected 22.05 kHz, got {rate}")
            if mel_path is not None:
                mel = np.load(mel_path)[0].T   # (1, 80, T) → (T, 80)
            else:
                mel = log_mel_spectrogram(audio.astype(np.float32),
                                          self.mel_cfg)
            n = min(mel.shape[0], len(audio) // self.hop)
            self._cache[idx] = (mel[:n].astype(np.float32),
                                audio[: n * self.hop].astype(np.float32))
        return self._cache[idx]

    def batches(self, batch_size: int = 16,
                segment_frames: int = SEGMENT_FRAMES
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Endless random (B, F, 80) mel and (B, F·hop) audio segments;
        an item no longer than F is zero-padded."""
        seg_samples = segment_frames * self.hop
        while True:
            mels = np.zeros((batch_size, segment_frames, 80), np.float32)
            auds = np.zeros((batch_size, seg_samples), np.float32)
            for b in range(batch_size):
                mel, audio = self._load(
                    int(self._rng.integers(len(self.items))))
                if mel.shape[0] <= segment_frames:
                    mels[b, : mel.shape[0]] = mel
                    auds[b, : len(audio)] = audio
                else:
                    start = int(self._rng.integers(
                        mel.shape[0] - segment_frames))
                    mels[b] = mel[start: start + segment_frames]
                    auds[b] = audio[start * self.hop:
                                    start * self.hop + seg_samples]
            yield mels, auds


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """``module``'s weights take no gradient inside."""
    params = list(module.parameters())
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _adamw(params, mesh=None) -> FusedAdamW:
    return FusedAdamW(params, b1=0.8, b2=0.99, eps=1e-8, weight_decay=0.01,
                      moment_dtype=torch.float32,
                      grad_sync=None if mesh is None
                      else data_sync(mesh, mean=True))


class VocoderTrainer:
    def __init__(self, gen_cfg: HiFiGANConfig = HiFiGANConfig(),
                 mel_cfg: MelConfig = MelConfig(),
                 learning_rate: float = 2e-4, lr_decay: float = 0.999,
                 mel_weight: float = 45.0, fm_weight: float = 2.0,
                 seed: int = 0,
                 disc_periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 disc_scales: int = 3, disc_width_div: int = 1,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        """Random weights from ``seed`` (the generator's first, then the
        discriminators'), on ``device`` (``cuda`` unless told otherwise)
        or on ``mesh``'s."""
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.gen_cfg, self.mel_cfg = gen_cfg, mel_cfg
        self.lr, self.lr_decay = learning_rate, lr_decay
        self.mel_weight, self.fm_weight = mel_weight, fm_weight
        rng = torch.Generator().manual_seed(seed)
        self.generator = init_generator(gen_cfg, rng).to(self.device)
        self.disc = HiFiGANDiscriminators(
            disc_periods, disc_scales, disc_width_div).init_weights(rng).to(
                self.device)
        self.gen_opt = _adamw(self.generator.parameters(), mesh)
        self.disc_opt = _adamw(self.disc.parameters(), mesh)

    def load_generator(self, checkpoint_path: str) -> None:
        """Warm start from an official checkpoint (fine-tuning); the
        generator's optimizer starts afresh."""
        self.generator.load_state_dict(
            load_generator_state(checkpoint_path), strict=True)
        self.gen_opt = _adamw(self.generator.parameters(), self.mesh)

    # ---------------- the step ----------------------------------------
    def train_step(self, mels, audio, lr: float) -> Dict[str, torch.Tensor]:
        """One GAN step on ``mels`` (B, F, 80) and ``audio`` (B, F·hop)
        (arrays or tensors) at learning rate ``lr``; returns the metrics as
        scalars on the device. On a mesh each rank takes its data rank's
        segments of the batch."""
        mels = torch.as_tensor(mels, dtype=torch.float32)
        audio = torch.as_tensor(audio, dtype=torch.float32)
        if self.mesh is not None:
            first, count = self.mesh.rows(mels.shape[0])
            mels, audio = (x[first: first + count] for x in (mels, audio))
        mels, audio = mels.to(self.device), audio.to(self.device)
        gen, disc = self.generator, self.disc
        for p in disc.parameters():
            p.grad = None
        with deterministic_cudnn():
            fake = gen(mels)
            real_s, _ = disc(audio)
            fake_s, _ = disc(fake.detach())
            d_loss = discriminator_loss(real_s, fake_s)
            d_loss.backward()
        self.disc_opt.step(lr)

        for p in gen.parameters():
            p.grad = None
        with deterministic_cudnn(), _frozen(disc):
            fake_s, fake_f = disc(fake)
            with torch.no_grad():
                _, real_f = disc(audio)
                real_mel = torch_log_mel_spectrogram(audio, self.mel_cfg)
            adv = generator_adversarial_loss(fake_s)
            fm = feature_matching_loss(real_f, fake_f)
            mel_l1 = torch.mean(torch.abs(
                torch_log_mel_spectrogram(fake, self.mel_cfg) - real_mel))
            g_loss = adv + self.fm_weight * fm + self.mel_weight * mel_l1
            g_loss.backward()
        self.gen_opt.step(lr)
        values = torch.stack([v.detach() for v in
                              (d_loss, g_loss, adv, fm, mel_l1)])
        if self.mesh is not None:
            values = all_reduce_(values, self.mesh.data_group) \
                / self.mesh.data_parallel
        return dict(zip(METRICS, values.unbind()))

    def learning_rate(self, step: int, steps_per_epoch: int) -> float:
        return float(np.float32(
            self.lr * self.lr_decay ** (step // steps_per_epoch)))

    # ---------------- checkpoints -------------------------------------
    @staticmethod
    def _opt_state(opt: FusedAdamW) -> dict:
        return {"mu": [m.detach().cpu() for m in opt.mu],
                "nu": [v.detach().cpu() for v in opt.nu],
                "count": opt.count}

    def save_state(self, directory: str, step: int = 0) -> str:
        """Write the full GAN state (both models, both optimizers, the
        step) to ``directory/vocoder_state.pt``, replaced atomically, so
        that the reference's 75k-step budget splits across sessions. On a
        mesh every rank calls it and rank 0 writes."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, STATE_FILE)
        if self.mesh is not None and self.mesh.rank:
            barrier(self.mesh)
            return path
        _atomic_save({
            "generator": {k: v.detach().cpu() for k, v in
                          self.generator.state_dict().items()},
            "disc": {k: v.detach().cpu() for k, v in
                     self.disc.state_dict().items()},
            "gen_opt": self._opt_state(self.gen_opt),
            "disc_opt": self._opt_state(self.disc_opt),
            "step": step}, path)
        if self.mesh is not None:
            barrier(self.mesh)
        return path

    @torch.no_grad()
    def load_state(self, directory: str) -> int:
        """The inverse of ``save_state``; returns the saved step."""
        state = torch.load(os.path.join(directory, STATE_FILE),
                           map_location="cpu", weights_only=True)
        self.generator.load_state_dict(state["generator"], strict=True)
        self.disc.load_state_dict(state["disc"], strict=True)
        for opt, saved in ((self.gen_opt, state["gen_opt"]),
                           (self.disc_opt, state["disc_opt"])):
            if len(saved["mu"]) != len(opt.mu):
                raise ValueError("the saved optimizer state does not match "
                                 "the model")
            for dst, src in zip(opt.mu + opt.nu, saved["mu"] + saved["nu"]):
                dst.copy_(src)
            opt.count = int(saved["count"])
        return int(state["step"])

    @staticmethod
    def state_exists(directory: str) -> bool:
        return os.path.isfile(os.path.join(directory, STATE_FILE))

    # ---------------- the loop ----------------------------------------
    def train(self, source: VocoderDataSource, steps: int,
              batch_size: int = 16, steps_per_epoch: int = 1000,
              log_every: int = 100, segment_frames: Optional[int] = None,
              on_step: Optional[Callable[[int, dict], None]] = None,
              start_step: int = 0, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None) -> dict:
        """Run ``steps`` new GAN steps from ``start_step`` (which keeps the
        per-epoch decay and the numbering of a resumed run); returns the
        last step's metrics as floats. ``on_step(i, metrics)`` gets floats
        after every step (a wait for the card each); without it the
        metrics are read only to log. ``checkpoint_every`` and
        ``checkpoint_dir`` write the full state every so many steps and at
        the end."""
        if segment_frames is not None and segment_frames <= 0:
            raise ValueError(f"segment_frames must be > 0, "
                             f"got {segment_frames}")
        batches = source.batches(
            batch_size,
            SEGMENT_FRAMES if segment_frames is None else segment_frames)
        metrics: Dict[str, torch.Tensor] = {}
        t0 = time.time()
        for i in range(start_step, start_step + steps):
            mels, audio = next(batches)
            metrics = self.train_step(mels, audio,
                                      self.learning_rate(i, steps_per_epoch))
            if on_step is not None:
                on_step(i, {k: float(v) for k, v in metrics.items()})
            if log_every and (i + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                logging.info(
                    "vocoder step %d: g=%.3f d=%.3f mel=%.3f (%.2f it/s)",
                    i + 1, m["g_loss"], m["d_loss"], m["mel_l1"],
                    (i + 1 - start_step) / (time.time() - t0))
            if (checkpoint_every and checkpoint_dir
                    and (i + 1) % checkpoint_every == 0):
                self.save_state(checkpoint_dir, step=i + 1)
        if checkpoint_dir is not None:
            self.save_state(checkpoint_dir, step=start_step + steps)
        return {k: float(v) for k, v in metrics.items()}

    def export_torch(self, path: str) -> None:
        """Write the generator as an official-format checkpoint,
        ``{'generator': state_dict}``, which ``models.hifigan.Vocoder`` and
        the released PyTorch code load (rank 0 of a mesh)."""
        if self.mesh is not None and self.mesh.rank:
            return
        _atomic_save({"generator": {k: v.detach().cpu() for k, v in
                                    self.generator.state_dict().items()}},
                     path)
