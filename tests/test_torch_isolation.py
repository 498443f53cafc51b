"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and its entry points do not fall back to the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch import (bench, bench_vocoder, evaluate,
                                     finetune_vocoder, make_normalizers,
                                     make_testset, make_vocoder_trainset,
                                     recognition_model, transduction_model)
from silent_speech_tpu_torch.capture import clean_audio, session
from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                            RecognitionTrainConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.data import dataset as dataset_module
from silent_speech_tpu_torch.data.dataset import ExampleList
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.data.device_featurize import \
    build_device_corpus
from silent_speech_tpu_torch.eval import export, server, streaming
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.models.hifigan import (HiFiGANConfig, Vocoder,
                                                    init_generator)
from silent_speech_tpu_torch.ops import batch_norm, build
from silent_speech_tpu_torch.parallel import collectives, launch, mesh
from silent_speech_tpu_torch import graft_entry
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer
from silent_speech_tpu_torch.train.transduction import TransductionTrainer
from silent_speech_tpu_torch.train.vocoder import VocoderTrainer
from silent_speech_tpu_torch.utils import debug_viz
from silent_speech_tpu_torch.utils import device as device_module
from silent_speech_tpu_torch.utils import native
from silent_speech_tpu_torch.utils.device import card_info, resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "absl",
             "silent_speech_tpu")
PORT_FILES = sorted((ROOT / "silent_speech_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_names_no_absl(path):
    # the card's machine has no absl: the port's CLIs parse with argparse
    assert "absl" not in path.read_text(), path.name


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


@pytest.fixture
def bundle_dir(tmp_path):
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=64, relative_positional_distance=4,
                      compute_dtype="float32")
    model = EMGEncoder(38, None, cfg).init_weights(
        torch.Generator().manual_seed(0))
    return export.save_serving_bundle(model, "recognition",
                                      str(tmp_path / "b"), t_buckets=(32,))


def test_cuda_entry_points_raise_without_a_card(no_card, bundle_dir):
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: card_info(),
                 lambda: export.ServingBundle.load(bundle_dir),
                 lambda: server.main(["--recognition_bundle", bundle_dir,
                                      "--port", "0"]),
                 lambda: TransductionTrainer()):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()


def test_cpu_is_taken_only_when_asked(bundle_dir):
    bundle = export.ServingBundle.load(bundle_dir, device="cpu",
                                       dtype=torch.float32)
    lp = bundle.predict(np.zeros((10, 112), np.float32),
                        np.zeros((80, 8), np.float32))
    assert bundle.device.type == "cpu" and lp.shape == (10, 38)
    assert next(bundle.model.parameters()).device.type == "cpu"


def test_trainer_runs_on_the_cpu_only_when_asked():
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=64, relative_positional_distance=4,
                      compute_dtype="float32")
    trainer = TransductionTrainer(
        cfg, DataConfig(seq_len=20, fixed_shapes=False),
        TransductionTrainConfig(), device="cpu")
    model = trainer.init_state(0)
    assert trainer.device.type == "cpu"
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    rng = np.random.default_rng(0)
    ex = {"emg": np.zeros((30, 112), np.float32),
          "raw_emg": rng.normal(size=(240, 8)).astype(np.float32),
          "session_ids": np.zeros(30, np.int64), "silent": False,
          "text_int": np.zeros(3, np.int64),
          "audio_features": rng.normal(size=(30, 80)).astype(np.float32),
          "phonemes": rng.integers(0, 48, size=30)}
    out = trainer.train_step(trainer._pack([ex]), 1e-3)
    assert out.loss.device.type == "cpu" and np.isfinite(out.loss.item())


def test_kernel_build_raises_on_a_missing_source():
    with pytest.raises(FileNotFoundError):
        build.build(["no_such_kernel"])


def _tiny_trainer(device, out_dir):
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=64, relative_positional_distance=4,
                      compute_dtype="float32")
    return TransductionTrainer(
        cfg, DataConfig(seq_len=20, fixed_shapes=False),
        TransductionTrainConfig(output_directory=str(out_dir)),
        device=device)


def _examples():
    rng = np.random.default_rng(0)
    return ExampleList([{
        "emg": np.zeros((30, 112), np.float32),
        "raw_emg": rng.normal(size=(240, 8)).astype(np.float32),
        "session_ids": np.zeros(30, np.int64), "silent": False,
        "text": "a b", "text_int": np.zeros(3, np.int64),
        "audio_features": rng.normal(size=(30, 80)).astype(np.float32),
        "phonemes": rng.integers(0, 48, size=30)} for _ in range(2)])


def test_training_entry_points_raise_without_a_card(no_card, tmp_path):
    data = _examples()
    for call in (lambda: bench.main([]),
                 lambda: bench.main(["--tiny"]),
                 lambda: transduction_model.main(
                     ["--output_directory", str(tmp_path)]),
                 lambda: evaluate.main(["--output_directory", str(tmp_path),
                                        "--models", "model.pt"]),
                 lambda: _tiny_trainer("cuda", tmp_path).fit(data, data)):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    assert not any(tmp_path.iterdir())   # raised before any work


def test_fit_runs_on_the_cpu_only_when_asked(tmp_path):
    trainer = _tiny_trainer("cpu", tmp_path)
    model = trainer.fit(_examples(), _examples(), epochs=1)
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert (tmp_path / "model.pt").is_file()


def _tiny_recognizer(device, out_dir):
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=64, relative_positional_distance=4,
                      compute_dtype="float32")
    return RecognitionTrainer(
        cfg, DataConfig(seq_len=20, fixed_shapes=False),
        RecognitionTrainConfig(output_directory=str(out_dir), lm_path=""),
        device=device)


def test_recognition_entry_points_raise_without_a_card(no_card, tmp_path):
    for call in (lambda: RecognitionTrainer(),
                 lambda: recognition_model.main(
                     ["--output_directory", str(tmp_path)]),
                 lambda: recognition_model.main(
                     ["--evaluate_saved", str(tmp_path / "model.pt")])):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    assert not any(tmp_path.iterdir())   # raised before any work


def test_recognition_fit_runs_on_the_cpu_only_when_asked(tmp_path):
    trainer = _tiny_recognizer("cpu", tmp_path)
    model = trainer.fit(_examples(), _examples(), epochs=1)
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {a.device.type for a in trainer.optimizer.acc} == {"cpu"}
    assert (tmp_path / "model.pt").is_file()


def test_the_native_search_builds_from_the_port_tree_alone():
    # its own copy of the C++ sources, the beam search's and the FLAC
    # decoder's, built by g++ into build/native; never the JAX package's
    # cpp/ directory or its Makefile
    assert native.SOURCE_DIR == ROOT / "silent_speech_tpu_torch" / "native"
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert "flac_codec.cc" in native.SOURCES
    for name in native.SOURCES:
        assert (native.SOURCE_DIR / name).is_file()
    assert native.library_path().parent == native.BUILD_DIR
    text = (ROOT / "silent_speech_tpu_torch" / "utils" / "native.py"
            ).read_text()
    assert "cpp/" not in text and "make" not in text
    for src in native.SOURCE_DIR.iterdir():
        for line in src.read_text().splitlines():
            if line.startswith("#include \""):
                assert (native.SOURCE_DIR / line.split('"')[1]).is_file()


def test_the_host_tools_touch_no_device(tmp_path, monkeypatch):
    # the corpus generator, make_normalizers, make_testset and the dataset
    # smoke run read and write files only: with every way to a device
    # made to fail, they run
    def refuse(*args, **kwargs):
        raise AssertionError("a host tool asked for a device")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    monkeypatch.setattr(device_module, "resolve_device", refuse)
    cfg = generate_corpus(str(tmp_path / "c"), n_voiced_sessions=1,
                          n_silent_sessions=1, utterances_per_session=3,
                          seed=1)
    args = ["--silent_data_directories", cfg.silent_data_directories[0],
            "--voiced_data_directories", cfg.voiced_data_directories[0],
            "--testset_file", str(tmp_path / "split.json"),
            "--text_align_directory", cfg.text_align_directory,
            "--normalizers_file", str(tmp_path / "n.pkl")]
    make_testset.main(args + ["--dev_size", "1", "--test_size", "1"])
    make_normalizers.main(args)
    assert dataset_module.main(args + ["--smoke_items", "2"]) == 2
    assert (tmp_path / "split.json").is_file()
    assert (tmp_path / "n.pkl").is_file()


def test_vocoder_entry_points_raise_without_a_card(no_card, tmp_path):
    cfg = HiFiGANConfig(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                        upsample_initial_channel=16,
                        resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1,),))
    gen = init_generator(cfg, torch.Generator().manual_seed(0))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"generator": gen.state_dict()}, ckpt / "g.pt")
    cfg.to_json(str(ckpt / "config.json"))
    voc_dir = export.save_vocoder_bundle(Vocoder(str(ckpt / "g.pt"),
                                                 device="cpu"),
                                         str(tmp_path / "voc"))
    out = tmp_path / "out"
    for call in (lambda: Vocoder(str(ckpt / "g.pt")),
                 lambda: export.ServingBundle.load(voc_dir),
                 lambda: server.main(["--vocoder_bundle", voc_dir,
                                      "--port", "0"]),
                 lambda: VocoderTrainer(),
                 lambda: bench_vocoder.main([]),
                 lambda: finetune_vocoder.main(
                     ["--data_directory", str(tmp_path), "--output_directory",
                      str(out)]),
                 lambda: make_vocoder_trainset.main(
                     ["--model", "model.pt", "--output_directory",
                      str(out)])):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    assert not out.exists()   # raised before any work


def test_vocoder_runs_on_the_cpu_only_when_asked(tmp_path):
    trainer = VocoderTrainer(
        gen_cfg=HiFiGANConfig(upsample_rates=(4, 2),
                              upsample_kernel_sizes=(8, 4),
                              upsample_initial_channel=16,
                              resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1,),)),
        disc_periods=(2,), disc_scales=1, disc_width_div=8, device="cpu")
    assert {p.device.type for p in trainer.generator.parameters()} | {
        p.device.type for p in trainer.disc.parameters()} == {"cpu"}
    trainer.export_torch(str(tmp_path / "g.pt"))
    trainer.gen_cfg.to_json(str(tmp_path / "config.json"))
    vocoder = Vocoder(str(tmp_path / "g.pt"), device="cpu")
    assert vocoder(np.zeros((3, 80), np.float32)).shape == (24,)


def test_streaming_and_device_featurization_raise_without_a_card(
        no_card, tmp_path):
    cfg = generate_corpus(str(tmp_path / "c"), n_voiced_sessions=1,
                          n_silent_sessions=1, utterances_per_session=3,
                          seed=1, dev_fraction=0.0, test_fraction=0.0)
    data = dataset_module.EMGDataset(cfg, no_testset=True,
                                     no_normalizers=True)
    for call in (lambda: streaming.main(["--seconds", "0.1"]),
                 lambda: streaming.demo_trainer(),
                 lambda: build_device_corpus(data),
                 lambda: build_device_corpus(data, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()


def test_the_filter_kernel_builds_from_the_repo_s_sources_alone():
    # csrc/filtfilt.cu includes the CUDA runtime only, and builds into
    # build/kernels at the root of the checkout (listed in .gitignore)
    src, out = build._target("filtfilt")
    assert src == ROOT / "silent_speech_tpu_torch" / "csrc" / "filtfilt.cu"
    assert out.parent == ROOT / "build" / "kernels"
    includes = [line for line in src.read_text().splitlines()
                if line.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>"]
    assert "filtfilt" in build.kernel_names()
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_an_int8_bundle_raises_without_a_card(no_card, tmp_path):
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=128, relative_positional_distance=4,
                      compute_dtype="float32")
    model = EMGEncoder(38, None, cfg).init_weights(
        torch.Generator().manual_seed(0))
    d = export.save_serving_bundle(model, "recognition", str(tmp_path / "q"),
                                   t_buckets=(32,), quantize="int8")
    for call in (lambda: export.ServingBundle.load(d),
                 lambda: server.main(["--recognition_bundle", d,
                                      "--port", "0"])):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()
    bundle = export.ServingBundle.load(d, device="cpu")
    assert {p.device.type for p in bundle.model.parameters()} == {"cpu"}
    assert torch.int8 in {p.dtype for p in bundle.model.parameters()}


def test_the_capture_tools_touch_no_device(tmp_path, monkeypatch):
    # the session, the cleaning and the debug plots
    # run on the host: with every way to a device made to fail, they run
    def refuse(*args, **kwargs):
        raise AssertionError("a host tool asked for a device")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    monkeypatch.setattr(device_module, "resolve_device", refuse)
    book = tmp_path / "b.txt"
    book.write_text("One here. Two there.")
    monkeypatch.setattr("builtins.input", lambda _prompt: "")
    out = str(tmp_path / "s")
    assert session.main(["--debug", "--seconds", "0.05", "--book_file",
                         str(book), "--output_directory", out]) == 2
    assert len(clean_audio.main([out, "--no_denoise"])) == 2
    path = str(tmp_path / "a.png")
    assert debug_viz.plot_alignment([0, 1, 1], save_path=path) == path


def test_mesh_entry_points_raise_without_a_card(no_card, tmp_path):
    # a mesh on CUDA never falls back to gloo on the CPU, nor to a virtual
    # mesh: each rank needs its card
    for call in (lambda: mesh.make_mesh(device="cuda"),
                 lambda: launch.spawn(launch.check_ranks, 1, (1, "cpu"),
                                      device="cuda"),
                 lambda: graft_entry.entry(),
                 lambda: graft_entry.dryrun_multichip(2),
                 lambda: transduction_model.main(
                     ["--output_directory", str(tmp_path),
                      "--model_parallel", "2"])):
        with pytest.raises(RuntimeError, match="CUDA|cards"):
            call()
    assert not torch.distributed.is_initialized()
    assert not any(tmp_path.iterdir())   # raised before any work


def test_a_mesh_issues_every_collective_even_for_one_rank():
    # a 1x1 mesh on the CPU: gloo, and the collectives run (and count)
    try:
        m = mesh.make_mesh(1, 1, device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        collectives.calls.count = 0
        x = torch.ones(3, requires_grad=True)
        y = collectives.reduce_from(collectives.copy_to(x, m.model_group),
                                    m.model_group)
        y.sum().backward()
        assert collectives.calls.count == 2
        assert torch.equal(x.grad, torch.ones(3))
    finally:
        mesh.destroy()


def test_the_batch_norm_kernels_take_every_tensor_off_the_cpu(monkeypatch):
    # the module imports without a card; a training forward of a tensor
    # off the CPU goes to the kernels' launch (here stopped at the
    # library), never to the plain composition
    def no_library():
        raise RuntimeError("the kernel library was asked for")

    monkeypatch.setattr(batch_norm, "_check", lambda *a: None)
    monkeypatch.setattr(batch_norm, "_library", no_library)
    bn = torch.nn.BatchNorm1d(4).to("meta")
    c = torch.zeros(2, 4, 8, device="meta")
    with pytest.raises(RuntimeError, match="kernel library was asked"):
        batch_norm.bn_relu(c, bn, True)
    with pytest.raises(RuntimeError, match="kernel library was asked"):
        batch_norm.bn_add_relu(c, bn, c, bn, True)
