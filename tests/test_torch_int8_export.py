"""The port's int8 serving (``eval/export.py``: ``quantize_state``,
``dequantize_state``, ``--export_int8``, the int8 ``ServingBundle``)
against the JAX package's ``quantize_tree``, ``dequantize_tree`` and its
int8 serving forward. The int8 values and scales must be bit-equal after
the layout map (``models/convert.jax_to_torch`` applied to each part of
the JAX tree); the float32 forward on the CPU within atol 1e-4 of the JAX
forward over the dequantized tree, as ``test_torch_serving.py`` holds the
float bundle."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.eval.export import (dequantize_tree,
                                           is_quantized_leaf as jax_is_q,
                                           quantize_tree)
from silent_speech_tpu_torch.eval import export
from silent_speech_tpu_torch.eval.server import ServingServer
from silent_speech_tpu_torch.models.convert import jax_to_torch

from test_torch_serving import _request, _utterance
from torch_port_util import jax_encoder, one_torch_thread, random_variables

BUCKETS = (64, 128)
HEADS = {"transduction": (80, 48), "recognition": (38, None)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Per kind: the JAX model and variables, the port's int8 bundle from
    the export CLI, and its state dict, all on the CPU in float32."""
    out = {}
    for i, (kind, (num_outs, aux)) in enumerate(sorted(HEADS.items())):
        root = tmp_path_factory.mktemp(kind)
        jmodel = jax_encoder(num_outs, aux)
        variables = random_variables(jmodel, seed=20 + i)
        state = jax_to_torch(variables["params"], variables["batch_stats"])
        torch.save(state, root / "model.pt")
        argv = ["--models", str(root / "model.pt"), "--output_directory",
                str(root / "int8"), "--t_buckets",
                ",".join(map(str, BUCKETS)), "--export_int8"]
        if kind == "recognition":
            argv.append("--recognition")
        export.main(argv)
        bundle = export.ServingBundle.load(str(root / "int8"), device="cpu",
                                           dtype=torch.float32)
        out[kind] = (jmodel, variables, state, bundle, root)
    return out


def _jax_parts(qtree, part):
    """The JAX quantized tree with each quantized leaf replaced by its
    ``part`` ("int8" or "scale")."""
    return jax.tree_util.tree_map(
        lambda n: n[part] if jax_is_q(n) else n, qtree, is_leaf=jax_is_q)


@pytest.mark.parametrize("min_size", [4096, 1])
@pytest.mark.parametrize("kind", sorted(HEADS))
def test_int8_values_and_scales_are_jax_s_bit_for_bit(bundles, kind,
                                                      min_size):
    _, variables, state, _, _ = bundles[kind]
    qtree = quantize_tree(variables["params"], min_size=min_size)
    ints = jax_to_torch(_jax_parts(qtree, "int8"))
    scales = jax_to_torch(_jax_parts(qtree, "scale"))
    ours = export.quantize_state(state, min_size=min_size)
    jax_keys = {k for k, v in ints.items() if v.dtype == torch.int8}
    our_keys = {k for k, v in ours.items() if export.is_quantized_leaf(v)}
    assert our_keys == jax_keys and len(our_keys) >= 10
    for k in our_keys:
        assert ours[k]["int8"].dtype == torch.int8
        assert ours[k]["scale"].dtype == torch.float32
        assert torch.equal(ours[k]["int8"], ints[k]), k
        assert torch.equal(ours[k]["scale"], scales[k]), k
    for k in set(state) - our_keys:
        assert ours[k] is state[k]


def test_the_projections_are_quantized_and_tables_and_norms_are_not(
        bundles):
    # min_size 1: a rule on shape and size alone would take the 3-D
    # relative tables; JAX's rule on flax names does not
    state = bundles["transduction"][2]
    ours = export.quantize_state(state, min_size=1)
    quantized = {k for k, v in ours.items() if export.is_quantized_leaf(v)}
    for w in ("w_q", "w_k", "w_v", "w_o"):
        assert f"transformer.layers.1.self_attn.{w}" in quantized
    for k in state:
        if ("relative_positional" in k or ".norm" in k or ".bn" in k
                or "res_norm" in k or k.endswith(".bias")):
            assert k not in quantized, k
    assert "w_raw_in.weight" in quantized
    assert "conv_blocks.0.conv1.weight" in quantized


def test_dequantize_state_is_within_half_a_step(bundles):
    state = bundles["transduction"][2]
    qstate = export.quantize_state(state)
    back = export.dequantize_state(qstate)
    for k, v in qstate.items():
        if export.is_quantized_leaf(v):
            assert back[k].dtype == torch.float32
            assert back[k].shape == state[k].shape
            err = (back[k] - state[k]).abs()
            assert bool((err <= 0.5 * v["scale"] * (1 + 1e-6)).all()), k
        else:
            assert torch.equal(back[k], state[k])


def test_the_export_cli_writes_an_int8_bundle(bundles):
    root = bundles["recognition"][4]
    manifest = json.loads((root / "int8" / "manifest.json").read_text())
    assert manifest["quantize"] == "int8"
    saved = torch.load(root / "int8" / "model.pt", weights_only=True)
    leaf = saved["transformer.layers.0.self_attn.w_q"]
    assert export.is_quantized_leaf(leaf)
    assert leaf["int8"].dtype == torch.int8
    assert leaf["scale"].shape == (2, 1, 32)   # (H, 1, d_head)
    assert saved["conv_blocks.1.conv1.weight"]["scale"].shape == (64, 1, 3)
    assert saved["w_raw_in.weight"]["scale"].shape == (64, 1)


def test_the_bundle_keeps_int8_weights_and_dequantizes_each_call(bundles):
    _, _, state, bundle, _ = bundles["transduction"]
    int8 = {n: p for n, p in bundle.model.named_parameters()
            if p.dtype == torch.int8}
    quantized = [k for k, v in export.quantize_state(state).items()
                 if export.is_quantized_leaf(v)]
    assert len(int8) == len(quantized)
    for k in quantized:
        module, _, name = k.rpartition(".")
        assert f"{module}.parametrizations.{name}.original" in int8
        # each access recomputes the float32 weight from int8 · scale
        w = bundle.model.get_submodule(module)
        assert getattr(w, name).dtype == torch.float32
    float_params = [n for n, p in bundle.model.named_parameters()
                    if p.dtype == torch.float32]
    assert all("parametrizations" not in n for n in float_params)


@pytest.mark.parametrize("kind", sorted(HEADS))
def test_int8_bundle_equals_its_dequantized_twin(bundles, kind, tmp_path):
    _, _, state, bundle, _ = bundles[kind]
    twin = export.EMGEncoder.from_state_dict(
        export.dequantize_state(export.quantize_state(state)))
    twin_dir = export.save_serving_bundle(twin, kind, str(tmp_path / "twin"),
                                          t_buckets=BUCKETS)
    twin_bundle = export.ServingBundle.load(twin_dir, device="cpu",
                                            dtype=torch.float32)
    emg, raw = _utterance(90, seed=3)
    sess = np.zeros(90, np.int64)
    assert np.array_equal(bundle.predict(emg, raw, sess),
                          twin_bundle.predict(emg, raw, sess))


def _jax_int8_served(jmodel, variables, kind, emg, raw):
    """JAX's int8 serving forward: ``apply`` over
    ``dequantize_tree(quantize_tree(params))``, bucket-padded and
    segment-masked as its export lowers it."""
    t = emg.shape[0]
    b = next(b for b in BUCKETS if t <= b)
    emg_p = np.zeros((1, b, 112), np.float32)
    emg_p[0, :t] = emg
    raw_p = np.zeros((1, 8 * b, 8), np.float32)
    raw_p[0, : 8 * t] = raw
    seg = np.zeros((1, b), np.int32)
    seg[0, :t] = 1
    params = dequantize_tree(quantize_tree(variables["params"]))
    out = jmodel.apply({"params": params,
                        "batch_stats": variables["batch_stats"]},
                       jnp.asarray(emg_p), jnp.asarray(raw_p),
                       jnp.zeros((1, b), jnp.int32),
                       segment_ids=jnp.asarray(seg), train=False)
    out = out[0] if kind == "transduction" else jax.nn.log_softmax(out, -1)
    return np.asarray(out)[0, :t]


@pytest.mark.parametrize("kind", sorted(HEADS))
@pytest.mark.parametrize("t", [20, 64, 100])
def test_int8_predict_matches_jax_int8_serving(bundles, kind, t):
    jmodel, variables, _, bundle, _ = bundles[kind]
    emg, raw = _utterance(t, seed=t + 1)
    ours = bundle.predict(emg, raw, np.zeros(t, np.int64))
    ref = _jax_int8_served(jmodel, variables, kind, emg, raw)
    assert ours.shape == ref.shape == (t, HEADS[kind][0])
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_a_bad_quantize_value_raises(bundles, tmp_path):
    state = bundles["recognition"][2]
    model = export.EMGEncoder.from_state_dict(state)
    with pytest.raises(ValueError, match="quantize must be one of"):
        export.save_serving_bundle(model, "recognition", str(tmp_path / "b"),
                                   t_buckets=BUCKETS, quantize="int4")
    d = export.save_serving_bundle(model, "recognition", str(tmp_path / "c"),
                                   t_buckets=BUCKETS)
    manifest = json.loads((tmp_path / "c" / "manifest.json").read_text())
    manifest["quantize"] = "int4"
    (tmp_path / "c" / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="unknown quantization"):
        export.ServingBundle.load(d, device="cpu")


def test_the_server_answers_from_int8_bundles(bundles):
    trans = bundles["transduction"][3]
    rec = bundles["recognition"][3]
    server = ServingServer(recognition=rec, transduction=trans).start()
    try:
        emg, raw = _utterance(40, seed=7)
        body = {"emg": emg.tolist(), "raw_emg": raw.tolist()}
        code, out = _request(server.port, "/v1/transduce",
                             {**body, "session_ids": [0] * 40})
        assert code == 200
        assert np.array_equal(np.asarray(out["mel"], np.float32),
                              trans.predict(emg, raw, np.zeros(40)))
        code, out = _request(server.port, "/v1/recognize", body)
        assert code == 200
        lp = np.asarray(out["log_probs"], np.float32)
        assert np.array_equal(lp, rec.predict(emg, raw))
        assert out["text"] == rec.decode_greedy(lp)
    finally:
        server.stop()
