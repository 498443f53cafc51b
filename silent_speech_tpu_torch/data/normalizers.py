"""Feature mean/std normalizers, pickle-compatible with the reference and
the JAX package.

Own copy of ``silent_speech_tpu/data/normalizers.py``: the reference
pickles two ``data_utils.FeatureNormalizer`` objects into
``normalizers.pkl`` (``read_emg.py:298-309``), ``mfcc_norm`` with (1, 80)
means and one shared scalar std, ``emg_norm`` with (1, 112) of each. The
loader maps that class, and the JAX package's
``silent_speech_tpu.data.normalizers.FeatureNormalizer``, to the port's own
class: the default ``find_class`` would import the JAX package.
"""

from __future__ import annotations

import pickle
from typing import List, Sequence, Tuple

import numpy as np


class FeatureNormalizer:
    """Z-scoring over (time, feature) samples (``data_utils.py:138-156``)."""

    def __init__(self, feature_samples: Sequence[np.ndarray] = None,
                 share_scale: bool = False):
        if feature_samples is not None:
            stacked = np.concatenate([np.asarray(f) for f in feature_samples],
                                     axis=0)
            self.feature_means = stacked.mean(axis=0, keepdims=True)
            self.feature_stddevs = (stacked.std() if share_scale
                                    else stacked.std(axis=0, keepdims=True))

    def normalize(self, sample: np.ndarray) -> np.ndarray:
        return (sample - self.feature_means) / self.feature_stddevs

    def inverse(self, sample: np.ndarray) -> np.ndarray:
        return sample * self.feature_stddevs + self.feature_means


class _CompatUnpickler(pickle.Unpickler):
    """A ``FeatureNormalizer`` of any module (the reference's
    ``data_utils``, the JAX package's) loads as the port's."""

    def find_class(self, module, name):
        if name == "FeatureNormalizer":
            return FeatureNormalizer
        return super().find_class(module, name)


def load_normalizers(path: str
                     ) -> Tuple[FeatureNormalizer, FeatureNormalizer]:
    with open(path, "rb") as f:
        mfcc_norm, emg_norm = _CompatUnpickler(f).load()
    return mfcc_norm, emg_norm


def save_normalizers(path: str, mfcc_norm: FeatureNormalizer,
                     emg_norm: FeatureNormalizer) -> None:
    with open(path, "wb") as f:
        pickle.dump((mfcc_norm, emg_norm), f)


def make_normalizers(dataset, n_samples: int = 51
                     ) -> Tuple[FeatureNormalizer, FeatureNormalizer]:
    """Normalizers from the first ``n_samples`` examples of ``dataset``
    (reference ``read_emg.py:298-309``): the mfcc statistics share one
    scalar std, the EMG ones are per dimension."""
    mfcc_samples: List[np.ndarray] = []
    emg_samples: List[np.ndarray] = []
    for d in dataset:
        mfcc_samples.append(np.asarray(d["audio_features"]))
        emg_samples.append(np.asarray(d["emg"]))
        if len(emg_samples) >= n_samples:
            break
    return (FeatureNormalizer(mfcc_samples, share_scale=True),
            FeatureNormalizer(emg_samples, share_scale=False))
