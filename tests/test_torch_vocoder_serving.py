"""The port's vocoder serving (``eval/export.py``, ``eval/server.py``)
against the JAX package's: ``vocode`` and ``denormalize`` of the JAX
``ServingBundle`` (run on the same generator through ``generator_apply``),
the manifest's normalizer, and ``/v1/transduce`` with a vocoder."""

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.eval.export import ServingBundle as JaxBundle
from silent_speech_tpu.models.hifigan import HiFiGANConfig as JaxConfig
from silent_speech_tpu.models.hifigan import (generator_apply,
                                              hifigan_torch_to_params)
from silent_speech_tpu_torch.config import ModelConfig
from silent_speech_tpu_torch.data.normalizers import (FeatureNormalizer,
                                                      save_normalizers)
from silent_speech_tpu_torch.eval import export
from silent_speech_tpu_torch.eval.server import ServingServer
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.models.hifigan import (HiFiGANConfig,
                                                    init_generator)

from torch_port_util import one_torch_thread

TINY_GEN = dict(resblock="1", upsample_rates=(4, 2),
                upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                num_mels=80)
MEL_BUCKETS = (16, 32)
# f32 convolutions, lax against torch on the CPU
VOCODE_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def vocoder_dir(tmp_path_factory):
    cfg = HiFiGANConfig(**TINY_GEN)
    gen = init_generator(cfg, torch.Generator().manual_seed(1))
    with torch.no_grad():   # biases off zero, weights large enough to matter
        for p in gen.parameters():
            p.add_(0.05 * torch.randn(p.shape,
                                      generator=torch.Generator().manual_seed(
                                          p.numel())))
    vocoder = types.SimpleNamespace(generator=gen, cfg=cfg)
    return export.save_vocoder_bundle(
        vocoder, str(tmp_path_factory.mktemp("voc")), mel_buckets=MEL_BUCKETS)


def _jax_bundle_of(bundle):
    """The JAX ``ServingBundle``'s vocoder methods over the same manifest,
    its exported forward replaced by ``generator_apply`` on the port's
    weights."""
    jcfg = JaxConfig(**TINY_GEN)
    params = jax.tree_util.tree_map(jnp.asarray, hifigan_torch_to_params(
        {k: v.numpy() for k, v in bundle.model.state_dict().items()}, jcfg))
    ns = types.SimpleNamespace(kind="vocoder", manifest=bundle.manifest,
                               params=params)
    ns._bucket = lambda t: JaxBundle._bucket(ns, t)
    ns._calls = {b: (lambda p, mel: generator_apply(p, jnp.asarray(mel),
                                                    jcfg))
                 for b in bundle.manifest["t_buckets"]}
    return ns


@pytest.mark.parametrize("t", [5, 16, 29])
def test_vocode_matches_the_jax_bundle(vocoder_dir, t):
    bundle = export.ServingBundle.load(vocoder_dir, device="cpu")
    assert bundle.kind == "vocoder"
    assert bundle.manifest["t_buckets"] == list(MEL_BUCKETS)
    assert bundle.manifest["hop_length"] == 8
    mel = np.random.default_rng(t).normal(size=(t, 80)).astype(np.float32)
    audio = bundle.vocode(mel)
    # JAX's own vocode: the log(1e-5) padding to the covering bucket, then
    # the slice to t·hop
    ref = JaxBundle.vocode(_jax_bundle_of(bundle), mel)
    assert audio.shape == ref.shape == (t * 8,)
    np.testing.assert_allclose(audio, ref, atol=VOCODE_ATOL, rtol=0)


def test_a_mel_over_the_largest_bucket_raises(vocoder_dir):
    bundle = export.ServingBundle.load(vocoder_dir, device="cpu")
    with pytest.raises(ValueError, match="largest exported bucket 32"):
        bundle.vocode(np.zeros((33, 80), np.float32))
    with pytest.raises(ValueError, match="needs a vocoder bundle"):
        export.ServingBundle.vocode(types.SimpleNamespace(
            kind="transduction"), np.zeros((3, 80), np.float32))


def _normalizer(seed=0):
    rng = np.random.default_rng(seed)
    n = FeatureNormalizer()
    n.feature_means = rng.normal(size=(1, 80)).astype(np.float32)
    n.feature_stddevs = rng.uniform(0.5, 2.0, size=(1, 80)).astype(
        np.float32)
    return n


@pytest.fixture(scope="module")
def transduction_dirs(tmp_path_factory):
    """A tiny transduction model exported by the CLI with and without a
    normalizers file, and the normalizer."""
    root = tmp_path_factory.mktemp("trans")
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=64, relative_positional_distance=4,
                      compute_dtype="float32")
    model = EMGEncoder(80, 48, cfg).init_weights(
        torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), root / "model.pt")
    norm = _normalizer()
    save_normalizers(str(root / "norm.pkl"), norm, _normalizer(1))
    dirs = {}
    for name, norm_file in (("with", root / "norm.pkl"),
                            ("without", root / "missing.pkl")):
        dirs[name] = export.main([
            "--models", str(root / "model.pt"), "--output_directory",
            str(root / name), "--t_buckets", "32",
            "--normalizers_file", str(norm_file)])
    return dirs, norm


def test_the_export_cli_embeds_the_normalizer(transduction_dirs):
    dirs, norm = transduction_dirs
    with open(f"{dirs['with']}/manifest.json") as f:
        manifest = json.load(f)
    assert manifest["audio_normalizer"] == {
        "means": norm.feature_means.ravel().tolist(),
        "stddevs": norm.feature_stddevs.ravel().tolist()}
    with_norm = export.ServingBundle.load(dirs["with"], device="cpu")
    without = export.ServingBundle.load(dirs["without"], device="cpu")
    assert with_norm.has_normalizer and not without.has_normalizer
    mel = np.random.default_rng(3).normal(size=(7, 80)).astype(np.float32)
    ref = JaxBundle.denormalize(
        types.SimpleNamespace(manifest=manifest), mel)
    np.testing.assert_array_equal(with_norm.denormalize(mel), ref)


def _post(port, route, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def test_transduce_returns_the_vocoded_mel(transduction_dirs, vocoder_dir):
    dirs, _ = transduction_dirs
    trans = export.ServingBundle.load(dirs["with"], device="cpu",
                                      dtype=torch.float32)
    voc = export.ServingBundle.load(vocoder_dir, device="cpu")
    server = ServingServer(transduction=trans, vocoder=voc).start()
    try:
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30).read())
        assert health["kinds"] == ["transduction", "vocoder"]
        t = 20
        rng = np.random.default_rng(4)
        reply = _post(server.port, "/v1/transduce", {
            "emg": rng.normal(size=(t, 112)).tolist(),
            "raw_emg": rng.normal(size=(8 * t, 8)).tolist(),
            "session_ids": [0] * t})
    finally:
        server.stop()
    mel = np.asarray(reply["mel"], np.float32)
    audio = np.asarray(reply["audio"], np.float32)
    assert mel.shape == (t, 80) and audio.shape == (t * 8,)
    np.testing.assert_array_equal(audio,
                                  voc.vocode(trans.denormalize(mel)))


def test_transduce_refuses_to_vocode_without_a_normalizer(
        transduction_dirs, vocoder_dir):
    dirs, _ = transduction_dirs
    trans = export.ServingBundle.load(dirs["without"], device="cpu",
                                      dtype=torch.float32)
    voc = export.ServingBundle.load(vocoder_dir, device="cpu")
    server = ServingServer(transduction=trans, vocoder=voc).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.port, "/v1/transduce", {
                "emg": np.zeros((4, 112)).tolist(),
                "raw_emg": np.zeros((32, 8)).tolist(),
                "session_ids": [0] * 4})
    finally:
        server.stop()
    assert err.value.code == 400
    assert "vocoding needs mel denormalization stats" in json.loads(
        err.value.read())["error"]
    with pytest.raises(ValueError, match="passed as the vocoder"):
        ServingServer(vocoder=trans)
