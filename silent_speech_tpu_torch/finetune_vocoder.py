"""CLI: fine-tune the HiFi-GAN vocoder on the card.

Counterpart of the JAX package's root ``finetune_vocoder.py``, with its
flags: the reference's external step (``README.md:67-75``: 75k steps from
UNIVERSAL_V1 on the output of ``make_vocoder_trainset``)::

    python -m silent_speech_tpu_torch.make_vocoder_trainset \\
        --model run/model.pt --output_directory voc_data [data flags]
    python -m silent_speech_tpu_torch.finetune_vocoder \\
        --data_directory voc_data --hifigan_checkpoint g_02500000 \\
        --steps 75000 --output_directory voc_out [--resume] [--device cpu]

The generator starts from ``--hifigan_checkpoint`` (its sibling
``config.json`` gives the architecture) or from seed 0. It writes
``log.txt``, the full GAN state (``vocoder_state.pt``, every
``--vocoder_checkpoint_every`` steps and at the end; ``--resume`` continues
from it with the step count and the learning-rate decay where they were)
and ``generator_finetuned.pt`` into ``--output_directory``. It runs on the
card unless ``--device cpu``. Under ``torchrun --nproc_per_node=N`` the
GAN trains data-parallel over the N ranks (``--vocoder_batch_size`` must
divide by the data axis); rank 0 alone writes files.
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
from typing import Optional, Sequence

from .config import TransductionTrainConfig
from .flags import _bool, _list, add_flag, add_mesh_flags, cli_mesh


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Fine-tune the HiFi-GAN "
                                 "vocoder (PyTorch port).")
    flag = functools.partial(add_flag, ap)
    flag("data_directory", None, "make_vocoder_trainset output directory",
         str)
    flag("steps", 75000, "fine-tuning steps")
    flag("vocoder_batch_size", 16, "segment batch size")
    flag("filelist_prefix", "train", "which filelist to train on")
    flag("vocoder_segment_frames", 32, "mel frames per training segment")
    flag("vocoder_disc_periods", ["2", "3", "5", "7", "11"],
         "MPD discriminator periods", _list)
    flag("vocoder_checkpoint_every", 1000,
         "save the full GAN state every N steps")
    flag("hifigan_checkpoint", None, "hifi-gan generator checkpoint", str)
    flag("output_directory", TransductionTrainConfig().output_directory,
         "output directory")
    flag("resume", False, "resume from the full GAN state in "
         "output_directory", _bool)
    add_mesh_flags(flag)
    flag("device", "cuda", "torch device to train on (cuda or cpu)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the last step's metrics."""
    from .models.hifigan import HiFiGANConfig
    from .train.vocoder import VocoderDataSource, VocoderTrainer
    from .utils.device import resolve_device
    from .utils.run_logging import (log_device_info, log_run_provenance,
                                    setup_rank_logging)

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work
    out_dir = args.output_directory
    mesh = cli_mesh(args, device)
    setup_rank_logging(out_dir, mesh)
    log_run_provenance()
    log_device_info(device if mesh is None else mesh.device)

    gen_cfg = HiFiGANConfig()
    if args.hifigan_checkpoint:
        cfg_json = os.path.join(os.path.dirname(args.hifigan_checkpoint),
                                "config.json")
        if os.path.exists(cfg_json):
            gen_cfg = HiFiGANConfig.from_json(cfg_json)
    trainer = VocoderTrainer(
        gen_cfg=gen_cfg,
        disc_periods=tuple(int(p) for p in args.vocoder_disc_periods),
        device=device, mesh=mesh)
    if args.hifigan_checkpoint:
        trainer.load_generator(args.hifigan_checkpoint)

    start_step = 0
    if args.resume and trainer.state_exists(out_dir):
        start_step = trainer.load_state(out_dir)
        logging.info("resumed vocoder state at step %d", start_step)

    source = VocoderDataSource(args.data_directory,
                               prefix=args.filelist_prefix,
                               hop=gen_cfg.hop_length)
    final = trainer.train(source, steps=args.steps,
                          batch_size=args.vocoder_batch_size,
                          segment_frames=args.vocoder_segment_frames,
                          start_step=start_step,
                          checkpoint_every=args.vocoder_checkpoint_every,
                          checkpoint_dir=out_dir)
    trainer.export_torch(os.path.join(out_dir, "generator_finetuned.pt"))
    logging.info("finetune done: %d new steps (at %d total), final "
                 "metrics %s", args.steps, start_step + args.steps,
                 {k: round(v, 4) for k, v in final.items()})
    return final


if __name__ == "__main__":
    main()
