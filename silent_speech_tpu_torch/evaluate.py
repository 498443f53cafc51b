"""CLI: evaluate an ensemble of transduction models on the test set.

Counterpart of the JAX package's root ``evaluate.py``::

    python -m silent_speech_tpu_torch.evaluate --models a.pt b.pt \\
        --silent_data_directories DIR --voiced_data_directories DIR \\
        --testset_file F --text_align_directory DIR --normalizers_file F \\
        --output_directory eval/ [--dev] [--hifigan_checkpoint G] \\
        [--device cpu]

It loads each reference-layout ``model.pt`` strictly into the
architecture the model flags describe (``--model_size``,
``--num_layers``; the transduction CLI's flags, under the same names),
averages the models' mel and phoneme heads, and writes ``loss: …
phoneme accuracy: …`` and the most confused phoneme pairs to
``eval_log.txt`` in ``--output_directory`` (and the console). ``--models``
takes paths separated by spaces or commas. ``--dev`` evaluates the dev
split instead of the test split. It runs on the card unless ``--device
cpu``. Without ``--hifigan_checkpoint`` it stops there, as the JAX CLI
does. With it, each utterance's ensemble prediction is denormalized,
vocoded and written as ``example_output_{i}.wav``, and the DeepSpeech
judge (``eval/asr.py``) reports the WER; without the ``deepspeech``
package the judge is skipped with a warning.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from .flags import _bool, _list, add_flag
from .transduction_model import build_parser as transduction_parser


def build_parser() -> argparse.ArgumentParser:
    ap = transduction_parser()
    ap.description = ("Evaluate an ensemble of transduction models "
                      "(PyTorch port).")
    ap.add_argument("--models", nargs="+", default=[],
                    help="reference-layout model.pt files to average")
    add_flag(ap, "dev", False, "evaluate dev instead of test", _bool)
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """Returns the ensemble's (loss, phoneme accuracy, confusion)."""
    import torch

    from .data.dataset import EMGDataset
    from .eval.synthesis import EnsemblePredictor
    from .phonemes import confusion_lines
    from .train.transduction import TransductionTrainer
    from .transduction_model import configs_from_args
    from .utils.device import resolve_device
    from .utils.run_logging import log_device_info, setup_run_logging

    args = build_parser().parse_args(argv)
    paths = [p for arg in args.models for p in _list(arg)]
    if not paths:
        raise SystemExit("pass at least one --models checkpoint")
    device = resolve_device(args.device)  # no card: raise before any work
    vocoder = None
    if args.hifigan_checkpoint is not None:  # a bad path: raise before too
        from .models.hifigan import Vocoder

        vocoder = Vocoder(args.hifigan_checkpoint, device=device)
    model_cfg, data_cfg, train_cfg = configs_from_args(args)
    setup_run_logging(train_cfg.output_directory, filename="eval_log.txt")
    testset = EMGDataset(data_cfg, dev=args.dev, test=not args.dev)
    trainer = TransductionTrainer(model_cfg, data_cfg, train_cfg,
                                  device=device)
    log_device_info(trainer.device)
    ensemble = EnsemblePredictor.from_state_dicts(
        trainer, [torch.load(p, map_location="cpu", weights_only=True)
                  for p in paths])
    loss, acc, confusion = ensemble.evaluate(testset)
    logging.info("loss: %.4f phoneme accuracy: %.2f", loss, acc * 100)
    for line in confusion_lines(confusion):
        logging.info(line)
    if vocoder is None:
        logging.warning(
            "no --hifigan_checkpoint: skipping wav synthesis and the ASR "
            "WER judge (reference evaluate.py:59-64 requires a vocoder)")
        return loss, acc, confusion

    from .eval.asr import evaluate_if_installed
    from .eval.synthesis import dump_all_outputs

    dump_all_outputs(ensemble, testset, train_cfg.output_directory,
                     testset.mfcc_norm, vocoder)
    evaluate_if_installed(testset, train_cfg.output_directory)
    return loss, acc, confusion


if __name__ == "__main__":
    main()
