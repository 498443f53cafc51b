"""Port's serving bundle and HTTP server vs the JAX bucket-padded,
segment-masked forward (what the JAX export lowers)."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.eval.decode import greedy_ctc_decode
from silent_speech_tpu_torch.eval import export
from silent_speech_tpu_torch.eval.server import ServingServer
from silent_speech_tpu_torch.models.convert import jax_to_torch

from torch_port_util import jax_encoder, random_variables

BUCKETS = (64, 128)
HEADS = {"transduction": (80, 48), "recognition": (38, None)}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """JAX model + variables and the port's CPU bundle, per kind."""
    out = {}
    for i, (kind, (num_outs, aux)) in enumerate(sorted(HEADS.items())):
        root = tmp_path_factory.mktemp(kind)
        jmodel = jax_encoder(num_outs, aux)
        variables = random_variables(jmodel, seed=10 + i)
        torch.save(jax_to_torch(variables["params"],
                                variables["batch_stats"]),
                   root / "model.pt")
        argv = ["--models", str(root / "model.pt"), "--output_directory",
                str(root / "bundle"), "--t_buckets",
                ",".join(map(str, BUCKETS))]
        if kind == "recognition":
            argv.append("--recognition")
        export.main(argv)
        bundle = export.ServingBundle.load(str(root / "bundle"),
                                           device="cpu", dtype=torch.float32)
        out[kind] = (jmodel, variables, bundle)
    return out


def _utterance(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, 112)).astype(np.float32),
            rng.normal(size=(8 * t, 8)).astype(np.float32))


def _jax_served(jmodel, variables, kind, emg, raw):
    """The JAX serving forward: pad to the bucket, segment-mask, slice."""
    t = emg.shape[0]
    b = next(b for b in BUCKETS if t <= b)
    emg_p = np.zeros((1, b, 112), np.float32)
    emg_p[0, :t] = emg
    raw_p = np.zeros((1, 8 * b, 8), np.float32)
    raw_p[0, : 8 * t] = raw
    seg = np.zeros((1, b), np.int32)
    seg[0, :t] = 1
    out = jmodel.apply(variables, jnp.asarray(emg_p), jnp.asarray(raw_p),
                       jnp.zeros((1, b), jnp.int32),
                       segment_ids=jnp.asarray(seg), train=False)
    out = out[0] if kind == "transduction" else jax.nn.log_softmax(out, -1)
    return np.asarray(out)[0, :t]


@pytest.mark.parametrize("kind", sorted(HEADS))
@pytest.mark.parametrize("t", [20, 64, 100])
def test_predict_matches_jax_serving_forward(bundles, kind, t):
    jmodel, variables, bundle = bundles[kind]
    emg, raw = _utterance(t, seed=t)
    ours = bundle.predict(emg, raw, np.zeros(t, np.int64))
    ref = _jax_served(jmodel, variables, kind, emg, raw)
    assert ours.shape == ref.shape == (t, HEADS[kind][0])
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_decode_greedy_matches_jax(bundles):
    jmodel, variables, bundle = bundles["recognition"]
    emg, raw = _utterance(100, seed=5)
    ref_lp = _jax_served(jmodel, variables, "recognition", emg, raw)
    chars = bundle.manifest["charset"]
    ref = "".join(chars[i] for i in
                  greedy_ctc_decode(ref_lp, blank_id=len(chars)))
    assert bundle.decode_greedy(bundle.predict(emg, raw)) == ref


def test_predict_rejects_like_the_jax_bundle(bundles):
    trans = bundles["transduction"][2]
    with pytest.raises(ValueError, match="require session_ids"):
        trans.predict(*_utterance(20, seed=0))
    with pytest.raises(ValueError, match="exceeds the largest exported"):
        trans.predict(*_utterance(129, seed=0), np.zeros(129, np.int64))


def _request(port, route, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_end_to_end(bundles):
    trans, rec = bundles["transduction"][2], bundles["recognition"][2]
    server = ServingServer(recognition=rec, transduction=trans).start()
    try:
        port = server.port
        assert _request(port, "/healthz") == (
            200, {"ok": True, "kinds": ["recognition", "transduction"]})

        emg, raw = _utterance(40, seed=1)
        body = {"emg": emg.tolist(), "raw_emg": raw.tolist()}
        code, out = _request(port, "/v1/transduce",
                             {**body, "session_ids": [0] * 40})
        assert code == 200
        np.testing.assert_allclose(
            np.asarray(out["mel"]), trans.predict(emg, raw, np.zeros(40)),
            atol=1e-6)
        code, out = _request(port, "/v1/recognize", body)
        assert code == 200 and np.asarray(out["log_probs"]).shape == (40, 38)
        assert out["text"] == rec.decode_greedy(np.asarray(out["log_probs"]))

        bad = {"emg": emg.tolist(), "raw_emg": raw[:-8].tolist()}
        assert _request(port, "/v1/recognize", bad)[0] == 400
        assert _request(port, "/v1/transduce", body)[0] == 400  # no sessions
        long_emg, long_raw = _utterance(129, seed=2)
        assert _request(port, "/v1/recognize",
                        {"emg": long_emg.tolist(),
                         "raw_emg": long_raw.tolist()})[0] == 400
        assert _request(port, "/v1/nope", body)[0] == 404
    finally:
        server.stop()


def test_padded_forward_is_not_a_solo_unpadded_forward(bundles):
    """The stride-1 conv of each ResBlock reads one frame past the end; in a
    padded input that frame is relu(bn(conv(0))), not zero, and attention
    carries the difference on. So ``predict`` (padded, as the JAX bundle)
    differs from a forward over the utterance alone, at the last frame most
    (JAX's ``TransductionTrainer.predict`` docstring claims equality)."""
    jmodel, variables, bundle = bundles["transduction"]
    emg, raw = _utterance(40, seed=40)
    padded = bundle.predict(emg, raw, np.zeros(40, np.int64))
    with torch.no_grad():
        solo = bundle.model(torch.from_numpy(raw)[None])[0][0].numpy()
    gap = np.abs(padded - solo).max(axis=-1)
    assert gap[-1] > 0.1 and gap[-1] == gap.max()
    np.testing.assert_allclose(
        padded, _jax_served(jmodel, variables, "transduction", emg, raw),
        atol=1e-4)
