"""CLI: train or evaluate the EMG→text CTC recognition model.

Counterpart of the JAX package's root ``recognition_model.py``, with its
flags under the same names and the recognition defaults (learning rate
3e-4, warmup 1000, l2 0, 200 epochs, 128,000 raw samples a batch), plus
the beam decoder's (``--lm_path``, ``--beam_width``, ``--lm_alpha``,
``--lm_beta``) and ``--device``::

    python -m silent_speech_tpu_torch.recognition_model \\
        --silent_data_directories DIR --voiced_data_directories DIR \\
        --testset_file F --text_align_directory DIR --normalizers_file F \\
        --output_directory run/ --lm_path lm.binary [--resume] [--device cpu]

It trains with gradient accumulation of 2, warmup and milestone decay,
reports the beam-decoded validation WER each epoch, and writes ``log.txt``,
``checkpoint.pt`` (the full train state, which ``--resume`` continues
from) and the reference-layout ``model.pt`` into ``--output_directory``.
Under ``torchrun --nproc_per_node=N`` it trains on a data × model mesh
(``--model_parallel M``), rank 0 alone writing files.
``--evaluate_saved PATH`` prints the test set's WER for a ``model.pt``, or
for the checkpoint in a directory. It runs on the card unless ``--device
cpu`` (or ``--debug``, which the reference uses to force the CPU).
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
from typing import Optional, Sequence

from .config import DataConfig, ModelConfig, RecognitionTrainConfig
from .flags import (_bool, add_data_flags, add_flag, add_mesh_flags, cli_mesh,
                    data_config_from_args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train or evaluate the EMG→text "
                                 "recognition model (PyTorch port).")
    m, d, r = ModelConfig(), DataConfig(), RecognitionTrainConfig()
    flag = functools.partial(add_flag, ap)

    # architecture.py:10-12
    flag("model_size", m.model_size, "number of hidden dimensions")
    flag("num_layers", m.num_layers, "number of layers")
    flag("dropout", m.dropout, "dropout")
    # recognition_model.py:20-28
    flag("batch_size", r.batch_size, "training batch size (unused, as in "
         "the reference: batches are filled to --max_batch_len)")
    flag("epochs", r.epochs, "number of training epochs")
    flag("learning_rate", r.learning_rate, "learning rate")
    flag("learning_rate_patience", r.learning_rate_patience,
         "learning rate decay patience (unused: the rate decays at "
         "milestones)")
    flag("learning_rate_warmup", r.learning_rate_warmup,
         "micro-steps of linear warmup")
    flag("start_training_from", None, "start training from this model",
         str)
    flag("l2", r.l2, "weight decay")
    flag("output_directory", r.output_directory, "output directory")
    flag("evaluate_saved", None, "run evaluation on given model file", str)
    flag("debug", r.debug, "debug: run on the CPU", _bool)
    add_data_flags(flag)
    # the JAX package's additions that the port shares
    flag("chunk_bucket", d.chunk_bucket,
         "pad packed batches to a multiple of this many chunks")
    flag("compute_dtype", m.compute_dtype,
         "encoder compute dtype (bfloat16|float32)")
    flag("resume", False, "resume training from the output_directory "
         "checkpoint (full state incl. schedules)", _bool)
    flag("fixed_shapes", d.fixed_shapes, "pad every batch to capacity "
         "caps, so every step has one shape", _bool)
    flag("max_batch_len", 0, "length-packed batch capacity in raw EMG "
         "samples (0 = the default, 128000)")
    flag("t_cap", d.t_cap, "fixed-shape cap on per-utterance frames")
    flag("utt_cap", d.utt_cap, "fixed-shape cap on utterances per batch")
    # the beam decoder (reference recognition_model.py:34-35)
    flag("lm_path", r.lm_path, "KenLM probing .binary or ARPA language "
         "model of the beam decoder")
    flag("beam_width", r.beam_width, "beam width")
    flag("lm_alpha", r.lm_alpha, "LM weight")
    flag("lm_beta", r.lm_beta, "word insertion bonus")
    # the port's own
    add_mesh_flags(flag)
    flag("device", "cuda", "torch device (cuda or cpu)")
    return ap


def configs_from_args(args):
    model = ModelConfig(model_size=args.model_size,
                        num_layers=args.num_layers, dropout=args.dropout,
                        compute_dtype=args.compute_dtype)
    data = data_config_from_args(
        args, chunk_bucket=args.chunk_bucket, fixed_shapes=args.fixed_shapes,
        t_cap=args.t_cap, utt_cap=args.utt_cap)
    train = RecognitionTrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.learning_rate,
        learning_rate_warmup=args.learning_rate_warmup,
        learning_rate_patience=args.learning_rate_patience,
        start_training_from=args.start_training_from, l2=args.l2,
        output_directory=args.output_directory,
        evaluate_saved=args.evaluate_saved, debug=args.debug,
        lm_path=args.lm_path, lm_alpha=args.lm_alpha, lm_beta=args.lm_beta,
        beam_width=args.beam_width)
    if args.max_batch_len:
        train.max_batch_len = args.max_batch_len
    return model, data, train


def evaluate_saved(trainer, data_cfg: DataConfig, path: str) -> float:
    """The test set's WER for the ``model.pt`` at ``path``, or for the
    checkpoint in the directory ``path``."""
    import torch

    from .data.dataset import EMGDataset
    from .train.checkpoint import checkpoint_exists, restore_checkpoint

    testset = EMGDataset(data_cfg, test=True)
    trainer.init_state(0)
    if os.path.isdir(path) and checkpoint_exists(path):
        restore_checkpoint(path, trainer)
    else:
        trainer.model.load_state_dict(torch.load(
            path, map_location="cpu", weights_only=True), strict=True)
    return trainer.evaluate_wer(testset)


def main(argv: Optional[Sequence[str]] = None):
    from .data.dataset import EMGDataset
    from .train.recognition import RecognitionTrainer
    from .utils.device import resolve_device
    from .utils.run_logging import (log_device_info, log_run_provenance,
                                    setup_rank_logging)

    args = build_parser().parse_args(argv)
    # no card: raise before any work
    device = resolve_device("cpu" if args.debug else args.device)
    model_cfg, data_cfg, train_cfg = configs_from_args(args)
    mesh = None if args.evaluate_saved is not None else cli_mesh(args,
                                                                 device)
    trainer = RecognitionTrainer(model_cfg, data_cfg, train_cfg,
                                 device=device, mesh=mesh)
    if args.evaluate_saved is not None:
        score = evaluate_saved(trainer, data_cfg, args.evaluate_saved)
        print("WER:", score)
        return score

    setup_rank_logging(train_cfg.output_directory, mesh)
    log_run_provenance()
    trainset = EMGDataset(data_cfg, dev=False, test=False)
    devset = EMGDataset(data_cfg, dev=True)
    logging.info("output example: %s", devset.example_indices[0])
    logging.info("train / dev split: %d %d", len(trainset), len(devset))
    log_device_info(trainer.device)
    trainer.fit(trainset, devset, seed=0, resume=args.resume)
    return trainer


if __name__ == "__main__":
    main()
