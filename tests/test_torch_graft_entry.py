"""``silent_speech_tpu_torch.graft_entry`` against the JAX package's
``__graft_entry__.py``: ``entry()``'s forward against JAX's at a tiny width
(the full-size model is not run on this CPU), with weights carried over
and the inputs drawn as JAX's ``entry`` draws them (float32, atol 1e-4, as
``test_torch_encoder.py``); ``dryrun_multichip(4, device="cpu")`` passing
JAX's seven checks on a 2×2 gloo mesh and printing a line a check; one
rank in this process; and asking for ranks on cards that are not there
raising."""

import numpy as np
import pytest
import torch

import jax
from silent_speech_tpu.phonemes import NUM_PHONES
from silent_speech_tpu_torch import graft_entry
from silent_speech_tpu_torch.graft_entry import (FULL, build_entry,
                                                 dryrun_multichip, entry)
from silent_speech_tpu_torch.models.convert import jax_to_torch

from torch_port_util import (jax_encoder, one_torch_thread, random_variables,
                             tiny_config, to_numpy)

CHECK_LINES = ("dryrun_multichip(4): mesh 2x2, loss=",
               "  cache-scan wave parity: mesh ",
               "  recognition CTC parity: mesh ",
               "  restore-on-mesh step: loss=",
               "  vocoder GAN step parity: mesh g=",
               "  serving export from sharded trainer: bundle vs live",
               "  cross-topology restore: 2x2 -> 1x1 loss ")


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def test_entry_forward_matches_jax_s_at_a_tiny_width():
    model = jax_encoder(80, NUM_PHONES)
    variables = random_variables(model, seed=4)
    forward, (raw,) = build_entry(
        tiny_config(), torch.device("cpu"),
        state=jax_to_torch(variables["params"], variables["batch_stats"]))
    # JAX's entry(): default_rng(0) draws the features, then the raw EMG
    rng = np.random.default_rng(0)
    emg = rng.normal(size=(8, 200, 112)).astype(np.float32)
    raw_np = rng.normal(size=(8, 1600, 8)).astype(np.float32)
    np.testing.assert_array_equal(raw.numpy(), raw_np)
    want = jax.jit(lambda v, e, r, s: model.apply(v, e, r, s, train=False))(
        variables, emg, raw_np, np.zeros((8, 200), np.int32))
    got = forward(raw)
    assert [tuple(o.shape) for o in got] == [(8, 200, 80),
                                             (8, 200, NUM_PHONES)]
    for o, r in zip(got, want):
        np.testing.assert_allclose(to_numpy(o), np.asarray(r), atol=1e-4)


def test_entry_is_the_full_size_model_on_the_card():
    assert (FULL.model_size, FULL.num_layers, FULL.num_heads,
            FULL.dim_feedforward) == (768, 6, 8, 3072)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            entry()


def test_dryrun_multichip_passes_the_seven_checks(capsys):
    lines = dryrun_multichip(4, device="cpu")
    printed = capsys.readouterr().out.splitlines()
    for prefix in CHECK_LINES:
        assert sum(line.startswith(prefix) for line in printed) == 1, prefix
    ticks = [line for line in lines if line.endswith(" done")]
    assert len(ticks) == 7 and printed == lines
    assert "param-tree exact over 95 leaves on 4-device sharding" \
        in lines[-2]


def test_one_rank_runs_in_this_process(capsys):
    # the card's path: one rank, its process group made and destroyed here
    lines = graft_entry.main(["--dryrun", "1", "--device", "cpu"])
    assert lines[0].startswith("dryrun_multichip(1): mesh 1x1, loss=")
    assert "rel 0.00e+00" in lines[2]     # the 1x1 mesh is the one process
    assert not torch.distributed.is_initialized()


def test_ranks_need_cards():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a second card")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        dryrun_multichip(2)


def test_two_ranks_on_one_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA ranks need 2 cards"):
        dryrun_multichip(2, device="cuda")
