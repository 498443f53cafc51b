"""The port's ``SizeAwareSampler`` yields the JAX sampler's batches."""

import numpy as np
import pytest

from silent_speech_tpu.data.sampler import SizeAwareSampler as JaxSampler
from silent_speech_tpu_torch.data.dataset import ExampleList
from silent_speech_tpu_torch.data.sampler import SizeAwareSampler


class _Meta:
    """Sampler metadata only: texts (some without a letter, which both
    samplers skip) and raw lengths, one longer than the capacity."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.meta = [{"text": "-- 12" if i % 11 == 5 else f"utterance {i}",
                      "emg_length": int(rng.integers(2000, 30000))}
                     for i in range(60)]
        self.meta[7]["emg_length"] = 90000

    def __len__(self):
        return len(self.meta)

    def example_meta(self, i):
        return self.meta[i]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("max_len", [64000, 40000])
def test_batches_match_jax_over_three_epochs(seed, max_len):
    data = _Meta(seed)
    ours = SizeAwareSampler(data, max_len, seed=seed)
    ref = JaxSampler(data, max_len, seed=seed)
    epochs = [(list(ours), list(ref)) for _ in range(3)]
    for got, want in epochs:
        assert got == want and len(got) > 3
    assert epochs[0][0] != epochs[1][0]   # a fresh shuffle each epoch


def test_example_list_lengths_are_the_raw_capture_lengths():
    rng = np.random.default_rng(0)
    ex = {"emg": np.zeros((200, 112), np.float32), "text": "a b",
          "raw_emg": rng.normal(size=(1600, 8))}
    data = ExampleList([ex] * 4)
    # 200 frames at hop 6 of 516.79 Hz, captured at 1 kHz
    assert data.example_meta(0) == {"text": "a b", "emg_length": 2322}
    assert len(data.subset(0.5)) == 2 and data[3] is ex
