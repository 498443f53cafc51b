"""Serving bundles: a reference-layout ``model.pt`` plus a manifest.

Counterpart of ``silent_speech_tpu/eval/export.py``. The JAX bundle ships
StableHLO per time bucket; this one ships the weights, and the architecture
is read back from their shapes. ``predict`` pads an utterance to the
smallest covering bucket, as the JAX bundle does, and masks the padding out
of attention with the utterance's length. Padding is not the same as an
unpadded forward: the stride-1 conv of each ResBlock reads one frame past
the end, which in a padded input is ``relu(bn(conv(0)))``, not zero.

Bundle layout (``directory/``)::

    manifest.json   kind, t_buckets, num_features, num_raw_channels,
                    quantize (null or "int8"), charset (recognition),
                    audio_normalizer (transduction, optional: the mel
                    denormalization means and stddevs)
    model.pt        reference-layout state dict; in an int8 bundle each
                    GEMM weight is {"int8": int8 tensor, "scale": float32
                    scale} (``quantize_state``)

An int8 bundle (``quantize="int8"``, the CLI's ``--export_int8``) holds the
GEMM weights as JAX's ``quantize_tree`` does: symmetric int8 with one
float32 scale per slice of the contraction axis. ``ServingBundle`` keeps
them resident as int8 on its device and dequantizes them to float32 on
every forward, where the JAX export dequantizes inside its jit; the
encoder then casts to its compute dtype as it does any weight.

A vocoder bundle (``save_vocoder_bundle``) holds the HiFi-GAN generator
with its weight norm folded: ``manifest.json`` (kind ``vocoder``, mel-frame
``t_buckets``, ``num_mels``, ``hop_length``, the generator's config) and
``generator.pt``. With a transduction bundle that carries a normalizer it
completes EMG → speech: ``vocode(denormalize(mel))``.

CLI — export a reference-layout checkpoint, such as the ``model.pt`` the
trainers write every epoch; a transduction bundle embeds the normalizer of
``--normalizers_file`` when that file exists::

    python -m silent_speech_tpu_torch.eval.export --models run/model.pt \
        --output_directory serving/ [--recognition] [--t_buckets 256,512] \
        [--normalizers_file normalizers.pkl] [--export_int8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from ..config import DataConfig
from ..data.normalizers import load_normalizers
from ..models.convert import state_leaves
from ..models.encoder import EMGEncoder
from ..models.hifigan import Generator, HiFiGANConfig
from ..text import CHARS
from ..utils.device import resolve_device
from .decode import greedy_ctc_decode

_MANIFEST = "manifest.json"
_WEIGHTS = "model.pt"
_GENERATOR = "generator.pt"

DEFAULT_T_BUCKETS = (256, 512, 1024, 2048)
DEFAULT_MEL_BUCKETS = (128, 256, 512, 1024)
KINDS = ("transduction", "recognition")
# the log-mel floor (dsp/mel.py: log(clip(x, 1e-5))): a vocoder pads with
# silence, not with the loud broadband energy a 0.0 log-mel would be
MEL_PAD = float(np.log(1e-5))

# input dims are fixed: 14 features x 8 channels, 8 raw EMG channels
N_FEATURES = 112
N_RAW_CHANNELS = 8


# --------------------------------------------------------------------------
# int8 weight-only quantization (serving)
# --------------------------------------------------------------------------

QUANTIZE = (None, "int8")
_QKEYS = frozenset(("int8", "scale"))
# the flax leaf names JAX quantizes: Dense/Conv kernels and the attention
# projections (silent_speech_tpu/eval/export.py:96)
_QNAMES = frozenset(("kernel", "w_q", "w_k", "w_v", "w_o"))
# the torch dim of the flax leaf's second-to-last axis, the contraction,
# under each map of models/convert.py: Dense (in, out) → (out, in) and Conv
# (k, in, out) → (out, in, k) put it at dim 1; the projections keep flax's
# (H, D, d_head) and (H, d_head, D)
_CONTRACTION_DIM = {"dense": 1, "conv": 1, "same": -2}


def _quantize_leaf(w: torch.Tensor, dim: int) -> dict:
    # float32 in JAX's order: max|w| / 127, clamped at 1e-12, then w / scale
    # rounded half to even and clipped to ±127
    scale = (w.abs().amax(dim=dim, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return {"int8": q, "scale": scale}


def is_quantized_leaf(node) -> bool:
    return isinstance(node, dict) and set(node) == _QKEYS


def quantize_state(state: Mapping[str, torch.Tensor], min_size: int = 4096
                   ) -> Dict[str, object]:
    """Per-channel symmetric int8 for every float GEMM weight of a
    reference-layout encoder state with at least ``min_size`` elements, as
    JAX's ``quantize_tree`` on the flax tree: the leaves are chosen by
    their flax names through ``models/convert.py``'s map (so the relative
    tables and the norms never are), and the int8 values and scales equal
    JAX's after the layout map. Everything else passes through."""
    leaves = {key: (path[-1], kind) for key, path, kind
              in state_leaves(state) if path}
    out: Dict[str, object] = {}
    for key, w in state.items():
        name, kind = leaves.get(key, ("", "same"))
        if (name in _QNAMES and w.ndim >= 2 and w.numel() >= min_size
                and w.is_floating_point()):
            out[key] = _quantize_leaf(w.float(), _CONTRACTION_DIM[kind])
        else:
            out[key] = w
    return out


def dequantize_state(qstate: Mapping[str, object]
                     ) -> Dict[str, torch.Tensor]:
    """Inverse of ``quantize_state``: ``int8 · scale`` in float32."""
    return {k: v["int8"] * v["scale"] if is_quantized_leaf(v) else v
            for k, v in qstate.items()}


class Int8Weight(nn.Module):
    """A parametrization: the weight is ``int8 · scale`` in float32,
    computed on every access from the int8 original and the scale, both
    resident on the module's device."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("scale", scale)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return q * self.scale


def _int8_encoder(qstate: Mapping[str, object], compute_dtype: str
                  ) -> EMGEncoder:
    """The encoder of a quantized state with each quantized weight held as
    its int8 tensor under an ``Int8Weight`` parametrization."""
    model = EMGEncoder.from_state_dict(dequantize_state(qstate),
                                       compute_dtype=compute_dtype)
    for key, leaf in qstate.items():
        if not is_quantized_leaf(leaf):
            continue
        module_name, _, name = key.rpartition(".")
        module = model.get_submodule(module_name)
        delattr(module, name)
        module.register_parameter(
            name, nn.Parameter(leaf["int8"], requires_grad=False))
        parametrize.register_parametrization(
            module, name, Int8Weight(leaf["scale"]), unsafe=True)
    return model


def _check_kind(model: EMGEncoder, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if (model.w_aux is not None) != (kind == "transduction"):
        raise ValueError(
            f"a {kind} model has {'a' if kind == 'transduction' else 'no'} "
            "phoneme head (w_aux); this checkpoint "
            f"{'lacks' if model.w_aux is None else 'has'} one")


def save_serving_bundle(model: EMGEncoder, kind: str, directory: str,
                        t_buckets: Sequence[int] = DEFAULT_T_BUCKETS,
                        charset: Optional[Sequence[str]] = None,
                        audio_normalizer=None,
                        quantize: Optional[str] = None) -> str:
    """Write ``model`` as a serving bundle of ``kind`` into ``directory``
    and return the directory. ``audio_normalizer`` (a
    ``FeatureNormalizer``, the dataset's ``mfcc_norm``) embeds the mel
    denormalization statistics, so that a vocoder runs without the
    corpus. ``quantize="int8"`` stores the weights ``quantize_state``
    quantizes as int8."""
    _check_kind(model, kind)
    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be one of {QUANTIZE}, got "
                         f"{quantize!r}")
    for t in t_buckets:
        if t <= 0 or t % 32:
            raise ValueError(f"bucket {t} must be a positive multiple of 32")
    os.makedirs(directory, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if quantize == "int8":
        state = quantize_state(state)
    torch.save(state, os.path.join(directory, _WEIGHTS))
    manifest = {
        "kind": kind,
        "t_buckets": sorted(int(t) for t in t_buckets),
        "num_features": N_FEATURES,
        "num_raw_channels": N_RAW_CHANNELS,
        "quantize": quantize,
    }
    if kind == "recognition":
        manifest["charset"] = list(CHARS if charset is None else charset)
    if audio_normalizer is not None:
        manifest["audio_normalizer"] = {
            "means": np.asarray(
                audio_normalizer.feature_means).ravel().tolist(),
            "stddevs": np.asarray(
                audio_normalizer.feature_stddevs).ravel().tolist(),
        }
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return directory


def save_vocoder_bundle(vocoder, directory: str,
                        mel_buckets: Sequence[int] = DEFAULT_MEL_BUCKETS
                        ) -> str:
    """Write the HiFi-GAN generator of ``vocoder`` (a
    ``models.hifigan.Vocoder``, or anything with ``.generator`` and
    ``.cfg``) as a vocoder bundle serving mels of up to the largest of
    ``mel_buckets`` frames; returns the directory."""
    os.makedirs(directory, exist_ok=True)
    cfg = vocoder.cfg
    torch.save({k: v.detach().cpu()
                for k, v in vocoder.generator.state_dict().items()},
               os.path.join(directory, _GENERATOR))
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump({"kind": "vocoder",
                   "t_buckets": sorted(int(b) for b in mel_buckets),
                   "num_mels": cfg.num_mels,
                   "hop_length": cfg.hop_length,
                   "generator_config": dataclasses.asdict(cfg)}, f,
                  indent=1)
    return directory


class ServingBundle:
    """A loaded bundle on ``device``: the encoder in ``dtype`` compute, or
    (kind ``vocoder``) the generator in float32, as the JAX bundle's. An
    int8 bundle's quantized weights stay int8 on the device and are
    dequantized on every forward."""

    def __init__(self, directory: str, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        with open(os.path.join(directory, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.kind = self.manifest["kind"]
        quantize = self.manifest.get("quantize")
        if quantize not in QUANTIZE:
            raise ValueError(f"unknown quantization {quantize!r}")
        if self.kind == "vocoder":
            self.model = Generator(HiFiGANConfig.from_dict(
                self.manifest["generator_config"]))
            self.model.load_state_dict(torch.load(
                os.path.join(directory, _GENERATOR), map_location="cpu",
                weights_only=True), strict=True)
        else:
            state = torch.load(os.path.join(directory, _WEIGHTS),
                               map_location="cpu", weights_only=True)
            cdt = str(dtype).removeprefix("torch.")
            self.model = (_int8_encoder(state, cdt) if quantize else
                          EMGEncoder.from_state_dict(state, compute_dtype=cdt))
            _check_kind(self.model, self.kind)
        self.model.to(self.device).eval()

    @classmethod
    def load(cls, directory: str, device=None,
             dtype: torch.dtype = torch.bfloat16) -> "ServingBundle":
        return cls(directory, device=device, dtype=dtype)

    def _bucket(self, t: int) -> int:
        for b in self.manifest["t_buckets"]:
            if t <= b:
                return b
        raise ValueError(
            f"utterance length {t} exceeds the largest exported bucket "
            f"{self.manifest['t_buckets'][-1]}; re-export with a larger "
            "t_buckets entry")

    def predict(self, emg: np.ndarray, raw_emg: np.ndarray,
                session_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Solo-utterance inference: ``emg`` (T, num_features), ``raw_emg``
        (T*8, raw_channels) → (T, 80) mel or (T, 38) CTC log-probs. The
        encoder reads only ``raw_emg``; ``emg`` gives T."""
        t = emg.shape[0]
        b = self._bucket(t)
        if session_ids is None and self.kind == "transduction":
            # the JAX bundle's contract: a silent all-zeros substitute would
            # give session-0 voice for every speaker once a model conditions
            # on sessions
            raise ValueError(
                "transduction bundles require session_ids (the model "
                "conditions on the session embedding)")
        raw_p = np.zeros((1, b * 8, raw_emg.shape[1]), np.float32)
        raw_p[0, : t * 8] = raw_emg
        raw = torch.from_numpy(raw_p).to(self.device)
        with torch.inference_mode():
            out = self.model(raw, valid_len=t)
            if self.kind == "transduction":
                out = out[0]  # (mel, phoneme_logits) → mel
            else:
                out = torch.log_softmax(out, dim=-1)
            return out[0, :t].cpu().numpy()

    @property
    def has_normalizer(self) -> bool:
        return "audio_normalizer" in self.manifest

    def denormalize(self, mel: np.ndarray) -> np.ndarray:
        """A normalized mel, as ``predict`` returns it, → the log-mel a
        vocoder takes: ``mel·std + mean`` with the embedded statistics."""
        n = self.manifest["audio_normalizer"]
        return (mel * np.asarray(n["stddevs"], np.float32)
                + np.asarray(n["means"], np.float32))

    def vocode(self, mel: np.ndarray) -> np.ndarray:
        """(vocoder bundles) mel (F, num_mels) → waveform (F·hop,). The mel
        is padded with the log-mel floor to the smallest covering bucket,
        as the JAX bundle pads, so the last samples, in the receptive field
        of the padding, may differ slightly from an unpadded run."""
        if self.kind != "vocoder":
            raise ValueError(f"vocode needs a vocoder bundle, not "
                             f"{self.kind}")
        t = mel.shape[0]
        mel_p = np.full((1, self._bucket(t), mel.shape[1]), MEL_PAD,
                        np.float32)
        mel_p[0, :t] = mel
        with torch.inference_mode():
            audio = self.model(torch.from_numpy(mel_p).to(self.device))
            return audio[0, : t * self.manifest["hop_length"]].cpu().numpy()

    def decode_greedy(self, log_probs: np.ndarray) -> str:
        """Greedy CTC transcript from ``predict`` output (recognition)."""
        if self.kind != "recognition":
            raise ValueError("decode_greedy needs a recognition bundle")
        chars = self.manifest["charset"]
        ids = greedy_ctc_decode(log_probs, blank_id=len(chars))
        return "".join(chars[i] for i in ids)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(
        description="Export a reference-layout model.pt as a serving "
                    "bundle for the PyTorch port.")
    ap.add_argument("--models", nargs=1, required=True,
                    help="the reference-layout model.pt to export")
    ap.add_argument("--output_directory", required=True)
    ap.add_argument("--recognition", action="store_true",
                    help="export a recognition model (default: "
                         "transduction)")
    ap.add_argument("--t_buckets",
                    default=",".join(str(t) for t in DEFAULT_T_BUCKETS),
                    help="time buckets in frames, multiples of 32")
    ap.add_argument("--normalizers_file",
                    default=DataConfig().normalizers_file,
                    help="pickled feature normalizers: a transduction "
                         "bundle embeds the mel normalizer when it exists")
    ap.add_argument("--export_int8", action="store_true",
                    help="weight-only per-channel int8 for the GEMM "
                         "weights (smaller resident weights)")
    args = ap.parse_args(argv)
    state = torch.load(args.models[0], map_location="cpu", weights_only=True)
    model = EMGEncoder.from_state_dict(state)
    kind = "recognition" if args.recognition else "transduction"
    audio_norm = None
    if kind == "transduction" and os.path.exists(args.normalizers_file):
        audio_norm, _ = load_normalizers(args.normalizers_file)
    out = save_serving_bundle(
        model, kind, args.output_directory,
        t_buckets=[int(t) for t in args.t_buckets.split(",")],
        audio_normalizer=audio_norm,
        quantize="int8" if args.export_int8 else None)
    print(f"wrote {kind} serving bundle → {out} (mel normalizer: "
          f"{'embedded' if audio_norm is not None else 'absent'}; "
          f"weights: {'int8' if args.export_int8 else 'float32'})")
    return out


if __name__ == "__main__":
    main()
