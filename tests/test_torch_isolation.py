"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and its entry points do not fall back to the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.config import ModelConfig
from silent_speech_tpu_torch.eval import export, server
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.ops import build
from silent_speech_tpu_torch.utils.device import card_info, resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "silent_speech_tpu")
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
                                      "--port", "0"])):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            call()


def test_cpu_is_taken_only_when_asked(bundle_dir):
    bundle = export.ServingBundle.load(bundle_dir, device="cpu",
                                       dtype=torch.float32)
    lp = bundle.predict(np.zeros((10, 112), np.float32),
                        np.zeros((80, 8), np.float32))
    assert bundle.device.type == "cpu" and lp.shape == (10, 38)
    assert next(bundle.model.parameters()).device.type == "cpu"


def test_kernel_build_raises_on_a_missing_source():
    with pytest.raises(FileNotFoundError):
        build.build(["no_such_kernel"])
