"""Benchmark: full-width transduction training steps a second on one card.

Counterpart of the JAX package's ``bench.py``. Four synthetic example sets
of ~22,000 frames each (the reference packs 256k raw-capture samples a
batch, ``transduction_model.py:166``) go into one ``DeviceCorpus`` on the
card; each step gathers its batch there from the set's utterance ids
(``train_step_ids``), so batch assembly is inside the timed window, and
runs the encoder forward (d=768, 6 layers, bf16), the DTW loss, the
backward and AdamW. After 2 warm-up steps, 3 trials of ``TRIAL_STEPS``
steps each are timed with the card synchronized at both ends; the median
trial counts.

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline"}``, with
``vs_baseline`` against the JAX bench's ``REFERENCE_STEPS_PER_SEC``, its
estimate of the reference PyTorch pipeline on one GPU.

    python -m silent_speech_tpu_torch.bench [--tiny] [--device cpu]

``--tiny`` shrinks the model and the batches so the same path can be run
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

REFERENCE_STEPS_PER_SEC = 3.0
WARMUP_STEPS = 2
TRIAL_STEPS = 8
TRIALS = 3


def build_examples(rng, target_frames=22000, silent_fraction=0.3,
                   max_len=800):
    """Synthetic utterances up to ``target_frames`` frames, about 30%
    silent (own copy of the JAX package's ``bench.py`` generator)."""
    examples = []
    total = 0
    while total < target_frames:
        t = int(rng.uniform(max_len * 3 // 8, max_len))
        silent = rng.uniform() < silent_fraction
        ex = {
            "emg": rng.normal(size=(t, 112)).astype(np.float32),
            "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
            "session_ids": np.zeros(t, dtype=np.int64),
            "silent": silent,
            "text": "benchmark",
            "text_int": rng.integers(0, 37, size=40).astype(np.int64),
        }
        if silent:
            tt = int(t * rng.uniform(0.9, 1.15))
            ex["parallel_voiced_audio_features"] = rng.normal(
                size=(tt, 80)).astype(np.float32)
            ex["parallel_voiced_emg"] = rng.normal(
                size=(tt, 112)).astype(np.float32)
            ex["phonemes"] = rng.integers(0, 48, size=tt).astype(np.int64)
        else:
            ex["audio_features"] = rng.normal(size=(t, 80)).astype(
                np.float32)
            ex["phonemes"] = rng.integers(0, 48, size=t).astype(np.int64)
        examples.append(ex)
        total += t
    return examples


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(step, device: torch.device, warmup: int = WARMUP_STEPS,
            trial_steps: int = TRIAL_STEPS, trials: int = TRIALS
            ) -> List[float]:
    """Steps a second of ``trials`` timed runs of ``trial_steps`` steps
    each, after ``warmup`` steps; ``step(i)`` runs step i and returns its
    output. Each trial ends by reading the last loss and synchronizing the
    card."""
    done = 0

    def run(n):
        nonlocal done
        for _ in range(n):
            out = step(done)
            done += 1
        return out

    run(warmup)
    _sync(device)
    rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        float(run(trial_steps).loss)
        _sync(device)
        rates.append(trial_steps / (time.perf_counter() - t0))
    return rates


def ids_steps(trainer, corpus, id_sets: Sequence[List[int]],
              lr: float = 1e-3):
    """``step(i)``: ``train_step_ids`` on the id set i mod 4; raises when a
    set exceeds the caps of on-device assembly."""
    def step(i):
        out = trainer.train_step_ids(corpus, id_sets[i % len(id_sets)], lr)
        if out is None:
            raise RuntimeError("a benchmark batch exceeded the caps of "
                               "on-device assembly")
        return out
    return step


def example_sets(tiny: bool = False) -> List[List[dict]]:
    """The 4 synthetic example sets, from seeds 0-3."""
    return [build_examples(np.random.default_rng(i),
                           target_frames=1000 if tiny else 22000,
                           max_len=120 if tiny else 800)
            for i in range(4)]


def setup(tiny: bool = False, device=None,
          sets: Optional[Sequence[List[dict]]] = None):
    """The trainer, its device corpus of the example sets (default
    ``example_sets(tiny)``), and each set's utterance ids."""
    from .config import DataConfig, ModelConfig, TransductionTrainConfig
    from .data.device_cache import DeviceCorpus
    from .train.transduction import TransductionTrainer

    cfgs = ModelConfig(), DataConfig(), TransductionTrainConfig()
    if tiny:  # ~1,000 frames a batch: 16 chunks of 200, t_cap 128
        cfgs = (ModelConfig(model_size=64, num_layers=2, num_heads=2,
                            dim_feedforward=128,
                            relative_positional_distance=16,
                            compute_dtype="float32"),
                DataConfig(t_cap=128),
                TransductionTrainConfig(max_batch_len=16000))
    trainer = TransductionTrainer(*cfgs, device=device)
    sets = example_sets(tiny) if sets is None else sets
    corpus = DeviceCorpus.build([e for s in sets for e in s],
                                trainer.device)
    id_sets, pos = [], 0
    for s in sets:
        id_sets.append(list(range(pos, pos + len(s))))
        pos += len(s)
    trainer.init_state(seed=0)
    return trainer, corpus, id_sets


def result_line(rates: Sequence[float]) -> dict:
    steps_per_sec = float(np.median(rates))
    return {"metric": "train_steps_per_sec_emg2mel",
            "value": round(steps_per_sec, 3),
            "unit": "steps/s",
            "vs_baseline": round(steps_per_sec / REFERENCE_STEPS_PER_SEC,
                                 2)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny model and batches (a check of the path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    trainer, corpus, id_sets = setup(args.tiny, args.device)
    line = result_line(measure(ids_steps(trainer, corpus, id_sets),
                               trainer.device))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
