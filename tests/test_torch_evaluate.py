"""The port's ``EnsemblePredictor`` and ``evaluate`` CLI against the JAX
package's ``EnsemblePredictor``: two JAX weight sets, converted with
``jax_to_torch``, evaluated on the dev split of a synthetic corpus (its
silent utterances run the DTW loss). Compared: the loss, the phoneme
accuracy and confusion (with ``test_torch_fit.py``'s tolerances), the
confusion report's lines, ``predict`` and ``get_aligned_prediction``. An
ensemble of one model twice gives that model's own evaluation. The CLI
runs end to end with ``--device cpu``. In its own file: the JAX trainer
switches the process to the ``rbg`` PRNG."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from silent_speech_tpu.config import DataConfig as JaxDataConfig
from silent_speech_tpu.data.dataset import EMGDataset as JaxDataset
from silent_speech_tpu.eval.synthesis import \
    EnsemblePredictor as JaxEnsemble
from silent_speech_tpu.phonemes import print_confusion as jax_confusion
from silent_speech_tpu_torch import evaluate
from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.data.dataset import EMGDataset
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.eval.synthesis import EnsemblePredictor
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.phonemes import print_confusion
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

from torch_port_util import (jax_encoder, jax_prng_impl_restored,
                             one_torch_thread, random_variables,
                             tiny_config)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_LEN = 48
GROUP = 2          # eval groups of 2 utterances: 2 groups of the 3
# as in test_torch_fit.py: float32, sums in another order; the loss to
# 2e-4 relative, one frame may move between confusion cells
VAL_RTOL = 2e-4
# the ensemble's mean mel prediction, float32 on both sides
PRED_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def prng_impl_restored_and_one_torch_thread():
    with jax_prng_impl_restored(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ours = generate_corpus(str(tmp_path_factory.mktemp("corpus")),
                           n_voiced_sessions=1, n_silent_sessions=1,
                           utterances_per_session=6, seed=11,
                           dev_fraction=0.5)
    fields = {f.name for f in dataclasses.fields(JaxDataConfig)}
    ref = JaxDataConfig(**{k: v for k, v in dataclasses.asdict(ours).items()
                           if k in fields})
    return ours, ref


@pytest.fixture(scope="module")
def weights():
    return [random_variables(jax_encoder(80, 48), seed=s) for s in (3, 4)]


def _port(weights):
    trainer = TransductionTrainer(
        tiny_config(), DataConfig(seq_len=SEQ_LEN, chunk_bucket=1,
                                  fixed_shapes=False),
        TransductionTrainConfig(), device="cpu")
    return EnsemblePredictor.from_state_dicts(
        trainer, [jax_to_torch(v["params"], v["batch_stats"])
                  for v in weights])


@pytest.fixture(scope="module")
def runs(corpus, weights):
    from silent_speech_tpu.config import Config
    from silent_speech_tpu.parallel.mesh import make_mesh
    from silent_speech_tpu.train.transduction import \
        TransductionTrainer as JaxTrainer

    ours_cfg, ref_cfg = corpus
    cfg = Config()
    m = cfg.model
    m.model_size, m.num_layers, m.num_heads = 64, 2, 2
    m.dim_feedforward, m.relative_positional_distance = 128, 16
    m.dropout, m.compute_dtype, m.shift_augment = 0.0, "float32", False
    m.fused_attention = False
    cfg.data = ref_cfg
    cfg.data.seq_len, cfg.data.chunk_bucket = SEQ_LEN, 1
    cfg.data.fixed_shapes = False
    ref_dev = JaxDataset(ref_cfg, dev=True)
    trainer = JaxTrainer(cfg, mesh=make_mesh(1, 1,
                                             devices=jax.devices()[:1]))
    trainer.init_state(trainer._pack([ref_dev[0]]), seed=0)
    ref = JaxEnsemble(base=trainer, states=[
        (v["params"], v["batch_stats"]) for v in weights])
    dev = EMGDataset(ours_cfg, dev=True)
    return _port(weights), ref, dev, ref_dev


def test_evaluate_matches_jax(runs):
    ours, ref, dev, ref_dev = runs
    assert len(dev) == len(ref_dev) == 3
    assert all(dev[i]["silent"] for i in range(len(dev)))
    loss, acc, confusion = ours.evaluate(dev, GROUP)
    ref_loss, ref_acc, ref_conf = ref.evaluate(ref_dev, GROUP)
    frames = ref_conf.sum()
    assert np.isfinite(loss) and loss == pytest.approx(ref_loss,
                                                       rel=VAL_RTOL)
    assert confusion.sum() == frames > 0
    assert abs(acc - ref_acc) <= 1 / frames
    assert np.abs(confusion - ref_conf).sum() <= 2
    # the report: the same lines from the same matrix
    assert print_confusion(ref_conf) == jax_confusion(ref_conf)


def test_predict_and_aligned_prediction_match_jax(runs):
    ours, ref, dev, ref_dev = runs
    example, ref_example = dev[0], ref_dev[0]
    pred = ours.predict(example)
    assert pred.shape == (example["emg"].shape[0], 80)
    np.testing.assert_allclose(pred, ref.predict(ref_example), rtol=0,
                               atol=PRED_ATOL)
    aligned = ours.get_aligned_prediction(example, dev.mfcc_norm)
    ref_aligned = ref.get_aligned_prediction(ref_example,
                                             ref_dev.mfcc_norm)
    target = example["parallel_voiced_audio_features"].shape[0]
    assert aligned.shape == ref_aligned.shape == (target, 80)
    scale = np.abs(ref_aligned).max()
    np.testing.assert_allclose(aligned, ref_aligned, rtol=0,
                               atol=PRED_ATOL * scale)


def test_two_equal_models_give_the_single_model_numbers(runs, weights):
    dev = runs[2]
    pair = _port([weights[0], weights[0]])
    single = pair.trainer
    single.model = pair.models[0]
    loss, acc, confusion = pair.evaluate(dev, GROUP)
    ref_loss, ref_acc, ref_conf = single.evaluate(dev, GROUP)
    assert (loss, acc) == (ref_loss, ref_acc)
    np.testing.assert_array_equal(confusion, ref_conf)
    np.testing.assert_array_equal(pair.predict(dev[1]),
                                  single.predict(dev[1]))


def test_an_empty_ensemble_raises(runs):
    with pytest.raises(ValueError, match="at least one model"):
        EnsemblePredictor(runs[0].trainer, [])


def _cli_args(cfg, out_dir, models):
    return ["--silent_data_directories",
            ",".join(cfg.silent_data_directories),
            "--voiced_data_directories",
            ",".join(cfg.voiced_data_directories),
            "--testset_file", cfg.testset_file,
            "--text_align_directory", cfg.text_align_directory,
            "--normalizers_file", cfg.normalizers_file,
            "--model_size", "64", "--num_layers", "2",
            "--compute_dtype", "float32", "--fixed_shapes=false",
            "--output_directory", str(out_dir), "--device", "cpu", "--dev",
            "--models", *models]


def test_cli_evaluates_an_ensemble_on_the_cpu(corpus, tmp_path):
    ours_cfg, _ = corpus
    model_cfg = ModelConfig(model_size=64, num_layers=2,
                            compute_dtype="float32")
    paths, models = [], []
    for seed in (0, 1):
        model = EMGEncoder(80, 48, model_cfg).init_weights(
            torch.Generator().manual_seed(seed))
        paths.append(str(tmp_path / f"m{seed}.pt"))
        torch.save(model.state_dict(), paths[-1])
        models.append(model)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "silent_speech_tpu_torch.evaluate",
         *_cli_args(ours_cfg, tmp_path / "eval", paths)],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    log = (tmp_path / "eval" / "eval_log.txt").read_text().splitlines()
    line = next(x for x in log if x.startswith("loss: "))
    loss, acc = map(float, re.fullmatch(
        r"loss: (\S+) phoneme accuracy: (\S+)", line).groups())
    trainer = TransductionTrainer(
        model_cfg, dataclasses.replace(ours_cfg, fixed_shapes=False),
        TransductionTrainConfig(), device="cpu")
    ref_loss, ref_acc, ref_conf = EnsemblePredictor(trainer, models) \
        .evaluate(EMGDataset(ours_cfg, dev=True))
    assert loss == pytest.approx(ref_loss, abs=5e-5)
    assert acc == pytest.approx(ref_acc * 100, abs=5e-3)
    first = log.index("Common confusions (confusion, accuracy)")
    assert log[first:first + 11] == print_confusion(ref_conf)
    assert "no --hifigan_checkpoint" in out.stderr


def test_cli_refuses_a_vocoder_and_an_empty_ensemble(corpus, tmp_path):
    # a vocoder checkpoint that is not there is refused before any work
    # (the vocoder branch itself: test_torch_synthesis_cli.py)
    ours_cfg, _ = corpus
    with pytest.raises(FileNotFoundError):
        evaluate.main(_cli_args(ours_cfg, tmp_path, ["m.pt"])
                      + ["--hifigan_checkpoint", str(tmp_path / "g.pt")])
    with pytest.raises(SystemExit, match="at least one --models"):
        evaluate.main(_cli_args(ours_cfg, tmp_path, [])[:-1])
    assert not any(tmp_path.iterdir())    # raised before any work
