"""CLI: build ``normalizers.pkl`` from a corpus's training split.

Counterpart of the JAX package's root ``make_normalizers.py`` (reference
``read_emg.py:298-309``): the mfcc statistics over the first 51 training
examples with one shared scalar std, the EMG statistics per dimension,
pickled as ``(mfcc_norm, emg_norm)``. Run once a corpus, before
training::

    python -m silent_speech_tpu_torch.make_normalizers \\
        --silent_data_directories DIR --voiced_data_directories DIR \\
        --testset_file F --text_align_directory DIR \\
        --normalizers_file normalizers.pkl

It reads the corpus on the host and touches no device.
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional, Sequence

from .flags import add_data_flags, add_flag, data_config_from_args


def main(argv: Optional[Sequence[str]] = None):
    from .data.dataset import make_normalizers_file

    ap = argparse.ArgumentParser(description="Build normalizers.pkl from a "
                                 "corpus (PyTorch port).")
    add_data_flags(functools.partial(add_flag, ap))
    cfg = data_config_from_args(ap.parse_args(argv))
    mfcc_norm, emg_norm = make_normalizers_file(cfg)
    print(f"wrote {cfg.normalizers_file}: "
          f"mfcc means {mfcc_norm.feature_means.shape} shared std, "
          f"emg means {emg_norm.feature_means.shape} per-dim std")
    return mfcc_norm, emg_norm


if __name__ == "__main__":
    main()
