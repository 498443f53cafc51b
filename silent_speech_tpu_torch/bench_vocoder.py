"""Benchmark: the HiFi-GAN V1 generator's real-time factor on the card.

Counterpart of the JAX package's root ``bench_vocoder.py``: the full V1
generator (random weights from seed 0, or ``--checkpoint``; the weights do
not change the work) vocodes a batch of ``--batch`` mels of ``--seconds``
each, five times after a warm-up call. RTF = seconds of audio made per
wall second (> 1 is faster than real time); ``vs_baseline`` is against real
time (1×), as in JAX. Prints one JSON line with JAX's four fields, the
card (``nvidia-smi``'s name and power limit) and whether cuDNN's TF32
convolutions were on::

    python -m silent_speech_tpu_torch.bench_vocoder [--checkpoint g.pt] \\
        [--seconds 10] [--batch 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .models.hifigan import HiFiGANConfig, Vocoder, init_generator
from .utils.device import card_info, resolve_device

TIMED_CALLS = 5


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="HiFi-GAN V1 real-time factor "
                                 "(PyTorch port).")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.checkpoint:
        vocoder = Vocoder(args.checkpoint, device=device)
        cfg, gen = vocoder.cfg, vocoder.generator
    else:
        cfg = HiFiGANConfig()
        gen = init_generator(cfg, torch.Generator().manual_seed(0)).to(
            device).eval()
    frames = int(args.seconds * 22050) // cfg.hop_length
    mel = torch.from_numpy(
        (np.random.default_rng(0).normal(size=(args.batch, frames,
                                               cfg.num_mels)) * 0.5
         ).astype(np.float32)).to(device)

    with torch.inference_mode():
        float(gen(mel).sum())   # warm-up, waited for
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            audio = gen(mel)
        float(audio.sum())
        dt = time.perf_counter() - t0

    audio_seconds = TIMED_CALLS * args.batch * frames * cfg.hop_length \
        / 22050
    rtf = audio_seconds / dt
    out = {"metric": "vocoder_rtf_hifigan_v1", "value": round(rtf, 1),
           "unit": "x_realtime", "vs_baseline": round(rtf / 1.0, 1),
           "card": card_info(device) if device.type == "cuda" else "cpu",
           "tf32_conv": bool(torch.backends.cudnn.allow_tf32)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
