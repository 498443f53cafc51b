"""CLI: write the vocoder's fine-tuning set from a trained transduction
model.

Counterpart of the JAX package's root ``make_vocoder_trainset.py`` (the
reference's, same flags): for the train set, then the dev set, each
utterance's prediction, DTW-warped onto the voiced target's timeline for a
silent utterance and denormalized (``TransductionTrainer.
get_aligned_prediction``, the DTW kernel on the card), is saved as
``mels/{train,dev}_output_{i}.npy`` of shape (1, 80, T) in float32, and its
audio, resampled to 22.05 kHz where needed and clipped to ±1, as
``wavs/{train,dev}_output_{i}.wav``, with one filelist per set; the input
HiFi-GAN fine-tuning expects (predicted, not gold, spectrograms)::

    python -m silent_speech_tpu_torch.make_vocoder_trainset \\
        --model run/model.pt --output_directory voc_data \\
        --silent_data_directories DIR --voiced_data_directories DIR \\
        --testset_file F --text_align_directory DIR --normalizers_file F \\
        [--model_size 768 --num_layers 6] [--device cpu]

``--model`` is a reference-layout ``model.pt``, loaded strictly into the
architecture the model flags describe. It runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .transduction_model import build_parser as transduction_parser

SAMPLE_RATE = 22050


def build_parser():
    ap = transduction_parser()
    ap.description = ("Write the vocoder's fine-tuning set from a trained "
                      "transduction model (PyTorch port).")
    ap.add_argument("--model", required=True,
                    help="checkpoint of model to run (reference-layout "
                         "model.pt)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Returns the number of utterances written."""
    import torch

    from .data.dataset import EMGDataset
    from .dsp.resample import resample_poly_audio
    from .train.transduction import TransductionTrainer
    from .transduction_model import configs_from_args
    from .utils.audio_io import read_audio, write_wav
    from .utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work
    model_cfg, data_cfg, train_cfg = configs_from_args(args)
    out_dir = train_cfg.output_directory

    trainset = EMGDataset(data_cfg, dev=False, test=False)
    devset = EMGDataset(data_cfg, dev=True)
    trainer = TransductionTrainer(model_cfg, data_cfg, train_cfg,
                                  device=device)
    trainer.init_state(0)
    trainer.model.load_state_dict(
        torch.load(args.model, map_location="cpu", weights_only=True),
        strict=True)

    os.makedirs(os.path.join(out_dir, "mels"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    written = 0
    for dataset, prefix in ((trainset, "train"), (devset, "dev")):
        with open(os.path.join(out_dir, f"{prefix}_filelist.txt"),
                  "w") as filelist:
            for i in range(len(dataset)):
                datapoint = dataset[i]
                spec = trainer.get_aligned_prediction(datapoint,
                                                      dataset.mfcc_norm)
                name = f"{prefix}_output_{i}"
                np.save(os.path.join(out_dir, "mels", f"{name}.npy"),
                        np.asarray(spec, np.float32).T[np.newaxis])
                audio, rate = read_audio(datapoint["audio_file"])
                if rate != SAMPLE_RATE:
                    audio = resample_poly_audio(audio, rate, SAMPLE_RATE)
                write_wav(os.path.join(out_dir, "wavs", f"{name}.wav"),
                          np.clip(audio, -1, 1), SAMPLE_RATE)
                filelist.write(f"{name}\n")
                written += 1
    return written


if __name__ == "__main__":
    main()
