"""The port's recognition ``fit()`` against the JAX trainer's ``fit()`` at
dropout 0, shift off, float32: the same examples, the same converted
initial weights, the same sampler seed, so the same batches. Each epoch
has an odd number of micro-steps (3), so the second epoch starts with a
half-full gradient accumulator; a milestone at epoch 1 halves the rate
for epoch 2. Compared: every micro-step's loss, each epoch's mean, the
validation WER of each epoch (beam search with an ARPA LM), and after
training the validation log-probs, the greedy and beam transcripts, and
``predict_logits``.

Packing has no whole padding chunks (``fixed_shapes`` off, chunk bucket
1, a one-device JAX mesh), as in ``test_torch_fit.py``. In its own file:
the JAX trainer switches the process to the ``rbg`` PRNG."""

import jax
import numpy as np
import pytest

from silent_speech_tpu.eval.decode import beam_ctc_decode as jax_beam
from silent_speech_tpu.eval.decode import greedy_ctc_decode as jax_greedy
from silent_speech_tpu_torch.config import DataConfig, RecognitionTrainConfig
from silent_speech_tpu_torch.data.dataset import ExampleList
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.text import TextTransform
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer

from test_kenlm_binary import ARPA
from torch_port_util import (jax_prng_impl_restored, one_torch_thread,
                             random_variables, record_calls, tiny_config)

SEQ_LEN = 48
FRAMES = 48
PER_BATCH = 4          # 12 examples: 3 micro-steps an epoch
EPOCHS = 2
# Adam's first updates move every weight by about the rate, however small
# its gradient, so the two sides' float32 rounding of near-zero gradients
# moves the later step losses by an amount that scales with the rate
# (measured with a larger space bias: 2.3e-4 relative at 1e-2, 3.3e-5 at
# 1e-3, 3.9e-6 at 1e-4; in this test, at 1e-4: 7.6e-7)
LR, WARMUP = 1e-4, 2
# the space symbol's output bias is raised, so that the random initial
# weights' greedy transcripts have several words and a WER other than 1
SPACE_BIAS = 1.5
BEAM = 8
SENTENCES = ("the cat", "the dog", "cat the dog", "the cat the",
             "dog cat", "the the cat")
# float32 on both sides, sums in another order: step losses to 1e-5
# relative (the first two, before any update, 1.1e-7 apart)
STEP_RTOL = 1e-5
# After the two fits the validation log-probs differ by up to 8e-3: the
# validation forward reads the BatchNorm statistics, which carry the conv
# biases that each side's Adam moves by ±LR on rounding noise
# (test_torch_fit.py). So the validation forward is compared on the JAX
# trainer's own final weights, converted: log-probs to 1e-4 absolute.
LOGP_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def prng_impl_restored_and_one_torch_thread():
    with jax_prng_impl_restored(), one_torch_thread():
        yield


def _example(rng, t, silent, sentence):
    tt = TextTransform()
    ex = {"emg": rng.normal(size=(t, 112)).astype(np.float32),
          "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
          "session_ids": np.zeros(t, np.int64), "silent": silent,
          "text": sentence,
          "text_int": np.asarray(tt.text_to_int(sentence), np.int64),
          "phonemes": rng.integers(0, 48, size=t)}
    key = "parallel_voiced_audio_features" if silent else "audio_features"
    ex[key] = rng.normal(size=(t, 80)).astype(np.float32)
    return ex


def _datasets():
    rng = np.random.default_rng(21)
    train = [_example(rng, FRAMES, i % 3 == 0, SENTENCES[i % 6])
             for i in range(12)]
    dev = [_example(rng, t, t == 40, s) for t, s in
           ((40, "the cat"), (36, "dog the cat"), (44, "the dog"))]
    return ExampleList(train), ExampleList(dev)


def _max_batch_len(train):
    return PER_BATCH * train.example_meta(0)["emg_length"]


def _jax_run(variables, train, dev, out_dir, lm_path):
    from silent_speech_tpu.config import Config
    from silent_speech_tpu.parallel.mesh import make_mesh
    from silent_speech_tpu.train.recognition import \
        RecognitionTrainer as JaxTrainer

    cfg = Config()
    m = cfg.model
    m.model_size, m.num_layers, m.num_heads = 64, 2, 2
    m.dim_feedforward, m.relative_positional_distance = 128, 16
    m.dropout, m.compute_dtype, m.shift_augment = 0.0, "float32", False
    m.fused_attention = False
    cfg.data.seq_len, cfg.data.chunk_bucket = SEQ_LEN, 1
    cfg.data.fixed_shapes = False
    r = cfg.recognition
    r.learning_rate, r.learning_rate_warmup = LR, WARMUP
    r.max_batch_len = _max_batch_len(train)
    r.output_directory, r.lm_path, r.beam_width = out_dir, lm_path, BEAM
    r.lr_milestones = (1,)
    trainer = JaxTrainer(cfg, mesh=make_mesh(1, 1,
                                             devices=jax.devices()[:1]))
    trainer.init_state(trainer._pack([train[0]]), seed=0)
    trainer.state = trainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    examples = [dev[i] for i in range(len(dev))]
    initial = (trainer.batch_logits(examples), trainer.evaluate_wer(dev),
               trainer.evaluate_wer(dev, beam=False))
    steps, wers = [], []
    record_calls(trainer, "_train_step", steps)
    record_calls(trainer, "evaluate_wer", wers)
    trainer.fit(train, dev, epochs=EPOCHS, seed=0)
    trained = {"params": jax.device_get(trainer.state.params),
               "batch_stats": jax.device_get(trainer.state.batch_stats)}
    return ([float(m["loss"]) for _, m in steps], wers,
            trainer.batch_logits(examples),
            trainer.predict_logits(examples[1]), trainer._get_lm(), trained,
            initial)


def _port_run(variables, train, dev, out_dir, lm_path):
    trainer = RecognitionTrainer(
        tiny_config(), DataConfig(seq_len=SEQ_LEN, chunk_bucket=1,
                                  fixed_shapes=False),
        RecognitionTrainConfig(learning_rate=LR, learning_rate_warmup=WARMUP,
                               max_batch_len=_max_batch_len(train),
                               output_directory=out_dir, lm_path=lm_path,
                               beam_width=BEAM, lr_milestones=(1,)),
        device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    initial = (trainer.transcripts(dev, beam=False),
               trainer.transcripts(dev), trainer.evaluate_wer(dev),
               trainer.evaluate_wer(dev, beam=False))
    steps, wers = [], []
    record_calls(trainer, "train_step", steps)
    record_calls(trainer, "evaluate_wer", wers)
    trainer.fit(train, dev, epochs=EPOCHS, seed=0)
    examples = [dev[i] for i in range(len(dev))]
    return ([float(s) for s in steps], wers, trainer.batch_logits(examples),
            trainer.predict_logits(examples[1]), trainer, initial)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from silent_speech_tpu.models.encoder import EMGEncoder as JaxEncoder
    from torch_port_util import TINY

    jmodel = JaxEncoder(num_outs=38, num_aux_outs=None, dropout=0.0,
                        fused_attention=False, shift_augment=False, **TINY)
    variables = random_variables(jmodel, seed=8)
    w_out = dict(variables["params"]["w_out"])
    w_out["bias"] = np.asarray(w_out["bias"]).copy()
    w_out["bias"][TextTransform().chars.index(" ")] += SPACE_BIAS
    variables["params"] = {**variables["params"], "w_out": w_out}
    train, dev = _datasets()
    root = tmp_path_factory.mktemp("rec_fit")
    lm_path = str(root / "lm.arpa")
    with open(lm_path, "w") as f:
        f.write(ARPA)
    return (_port_run(variables, train, dev, str(root / "port"), lm_path),
            _jax_run(variables, train, dev, str(root / "jax"), lm_path), dev)


def test_step_losses_match_jax(runs):
    (ours, *_), (ref, *_), _ = runs
    assert len(ours) == len(ref) == EPOCHS * 12 // PER_BATCH
    np.testing.assert_allclose(ours, ref, rtol=STEP_RTOL)


def test_epoch_losses_match_jax(runs):
    (ours, *_), (ref, *_), _ = runs
    per_epoch = 12 // PER_BATCH
    for e in range(EPOCHS):
        part = slice(e * per_epoch, (e + 1) * per_epoch)
        assert np.mean(ours[part]) == pytest.approx(np.mean(ref[part]),
                                                    rel=STEP_RTOL)


def test_accumulator_crosses_the_epoch(runs):
    trainer = runs[0][4]
    # 6 micro-steps in 2 epochs of 3: updates after micro-steps 2, 4, 6
    assert trainer.optimizer.count == 3 and trainer.optimizer.mini_step == 0


def test_validation_wer_matches_jax(runs):
    (_, wers, *_, initial), (_, ref_wers, *_, ref_initial) = runs[:2]
    assert len(wers) == len(ref_wers) == EPOCHS
    # before training (random weights: characters and words come out) and
    # after each epoch; greedy before training
    assert [initial[2]] + wers == [ref_initial[1]] + ref_wers
    assert initial[3] == ref_initial[2] > 1   # insertions


@pytest.fixture(scope="module")
def on_jax_weights(runs):
    """The port's trainer holding the JAX trainer's final weights."""
    trainer, trained = runs[0][4], runs[1][5]
    trainer.model.load_state_dict(
        jax_to_torch(trained["params"], trained["batch_stats"]))
    return trainer


def test_validation_log_probs_match_jax(runs, on_jax_weights):
    (_, _, ref_lps, ref_one, *_), dev = runs[1], runs[2]
    examples = [dev[i] for i in range(len(dev))]
    lps = on_jax_weights.batch_logits(examples)
    for ours, ref in zip(lps, ref_lps):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=LOGP_ATOL)
    np.testing.assert_allclose(on_jax_weights.predict_logits(examples[1]),
                               ref_one, rtol=0, atol=LOGP_ATOL)


def _jax_transcripts(lps, lm, trainer):
    chars, blank = trainer.text_transform.chars, trainer.blank_id
    text = trainer.text_transform.int_to_text
    return ([text(jax_greedy(lp, blank)) for lp in lps],
            [text(jax_beam(lp, chars, blank, beam_width=BEAM, lm=lm,
                           alpha=1.5, beta=1.85)) for lp in lps])


def test_transcripts_match_jax_before_training(runs):
    (*_, trainer, (greedy, beam, *_)), (*_, ref_lm, _, ref_initial) = \
        runs[:2]
    ref_greedy, ref_beam = _jax_transcripts(ref_initial[0], ref_lm, trainer)
    assert greedy == ref_greedy and beam == ref_beam
    # the decoders had work to do
    assert all(beam) and all(len(g.split()) > 1 for g in greedy)


def test_transcripts_match_jax(runs, on_jax_weights):
    (_, _, ref_lps, _, ref_lm, *_), dev = runs[1], runs[2]
    trainer = on_jax_weights
    ref_greedy, ref_beam = _jax_transcripts(ref_lps, ref_lm, trainer)
    beam = trainer.transcripts(dev)
    assert trainer.transcripts(dev, beam=False) == ref_greedy
    assert beam == ref_beam
    assert trainer.decode(dev[1]) == beam[1]
