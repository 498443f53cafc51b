"""CLI: train the EMG→mel transduction model.

Counterpart of the JAX package's root ``transduction_model.py``, with its
transduction and data flags under the same names and defaults
(``silent_speech_tpu/config.py:193-279``) plus ``--device``::

    python -m silent_speech_tpu_torch.transduction_model \\
        --silent_data_directories DIR --voiced_data_directories DIR \\
        --testset_file F --text_align_directory DIR --normalizers_file F \\
        --output_directory run/ [--resume] [--device cpu]

It trains with warmup × plateau AdamW, validates each epoch, and writes
``log.txt``, ``checkpoint.pt`` (the full train state, which ``--resume``
continues from) and the reference-layout ``model.pt`` into
``--output_directory``. It runs on the card unless ``--device cpu``.
Booleans take the JAX CLI's forms: ``--resume``, ``--noresume``,
``--fixed_shapes=false``; lists are comma-separated.

With ``--hifigan_checkpoint G`` (a generator checkpoint with its
``config.json`` beside it) each epoch also writes
``epoch_{epoch}_output.wav`` of the first dev utterance, and after
training every dev utterance is vocoded to ``example_output_{i}.wav`` and
judged by the DeepSpeech ASR (``eval/asr.py``). Without the ``deepspeech``
package the judge is skipped with a warning and the run ends normally, as
the JAX ``evaluate.py`` handles it (the JAX ``transduction_model.py``
ends with the ``ImportError`` instead).

On N cards it runs under ``torchrun --nproc_per_node=N -m
silent_speech_tpu_torch.transduction_model ... [--model_parallel M]``:
a data × model mesh of N/M × M ranks (``parallel/mesh.py``); rank 0
alone writes ``log.txt``, checkpoints and outputs.
"""

from __future__ import annotations

import argparse
import functools
import logging
from typing import Optional, Sequence

from .config import DataConfig, ModelConfig, TransductionTrainConfig
from .flags import (_bool, add_data_flags, add_flag, add_mesh_flags, cli_mesh,
                    data_config_from_args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the EMG→mel "
                                 "transduction model (PyTorch port).")
    m, d, t = ModelConfig(), DataConfig(), TransductionTrainConfig()
    flag = functools.partial(add_flag, ap)

    # architecture.py:10-12
    flag("model_size", m.model_size, "number of hidden dimensions")
    flag("num_layers", m.num_layers, "number of layers")
    flag("dropout", m.dropout, "dropout")
    # transduction_model.py:22-31
    flag("batch_size", 32, "training batch size (unused, as in the "
         "reference: batches are filled to --max_batch_len)")
    flag("epochs", t.epochs, "number of training epochs")
    flag("learning_rate", t.learning_rate, "learning rate")
    flag("learning_rate_patience", t.learning_rate_patience,
         "learning rate decay patience")
    flag("learning_rate_warmup", t.learning_rate_warmup,
         "steps of linear warmup")
    flag("start_training_from", None, "start training from this model",
         str)
    flag("data_size_fraction", t.data_size_fraction,
         "fraction of training data to use")
    flag("phoneme_loss_weight", t.phoneme_loss_weight,
         "weight of auxiliary phoneme loss")
    flag("l2", t.l2, "weight decay")
    flag("output_directory", t.output_directory, "output directory")
    flag("hifigan_checkpoint", None, "hifi-gan generator checkpoint", str)
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
         "samples (0 = the default, 256000)")
    flag("t_cap", d.t_cap, "fixed-shape cap on per-utterance frames")
    flag("utt_cap", d.utt_cap, "fixed-shape cap on utterances per batch")
    add_mesh_flags(flag)
    # the port's own
    flag("device", "cuda", "torch device to train on (cuda or cpu)")
    return ap


def configs_from_args(args):
    model = ModelConfig(model_size=args.model_size,
                        num_layers=args.num_layers, dropout=args.dropout,
                        compute_dtype=args.compute_dtype)
    data = data_config_from_args(
        args, chunk_bucket=args.chunk_bucket, fixed_shapes=args.fixed_shapes,
        t_cap=args.t_cap, utt_cap=args.utt_cap)
    train = TransductionTrainConfig(
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        learning_rate_patience=args.learning_rate_patience,
        learning_rate_warmup=args.learning_rate_warmup,
        start_training_from=args.start_training_from,
        data_size_fraction=args.data_size_fraction,
        phoneme_loss_weight=args.phoneme_loss_weight, l2=args.l2,
        output_directory=args.output_directory)
    if args.max_batch_len:
        train.max_batch_len = args.max_batch_len
    return model, data, train


def main(argv: Optional[Sequence[str]] = None):
    from .data.dataset import EMGDataset
    from .train.transduction import TransductionTrainer
    from .utils.device import resolve_device
    from .utils.run_logging import (log_device_info, log_run_provenance,
                                    setup_rank_logging)

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work
    vocoder = None
    if args.hifigan_checkpoint is not None:  # a bad path: raise before too
        from .models.hifigan import Vocoder

        vocoder = Vocoder(args.hifigan_checkpoint, device=device)
    model_cfg, data_cfg, train_cfg = configs_from_args(args)
    mesh = cli_mesh(args, device)
    setup_rank_logging(train_cfg.output_directory, mesh)
    log_run_provenance()

    trainset = EMGDataset(data_cfg, dev=False, test=False)
    devset = EMGDataset(data_cfg, dev=True)
    logging.info("output example: %s", devset.example_indices[0])
    logging.info("train / dev split: %d %d", len(trainset), len(devset))

    trainer = TransductionTrainer(model_cfg, data_cfg, train_cfg,
                                  device=device, mesh=mesh)
    log_device_info(trainer.device)
    trainer.fit(trainset, devset, vocoder=vocoder,
                save_sound_outputs=vocoder is not None, seed=0,
                resume=args.resume)
    if vocoder is not None and (mesh is None or mesh.rank == 0):
        from .eval.asr import evaluate_if_installed
        from .eval.synthesis import dump_all_outputs

        out_dir = train_cfg.output_directory
        dump_all_outputs(trainer, devset, out_dir, devset.mfcc_norm,
                         vocoder)
        evaluate_if_installed(devset, out_dir)
    return trainer


if __name__ == "__main__":
    main()
