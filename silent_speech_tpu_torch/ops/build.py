"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout; the
hash covers the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Several kernels build in parallel, one
``nvcc`` each. A build that fails raises with nvcc's own messages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled with the CUDA "
        "toolkit's nvcc; put it on PATH or set CUDA_HOME")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile the named kernels (default: every ``csrc/*.cu``) that are
    not built yet, all nvcc processes started together. Returns, for each
    kernel compiled now, its build seconds and nvcc's messages (ptxas
    register and shared-memory use)."""
    names = kernel_names() if names is None else list(names)
    pending = {}
    for name in names:
        src, out = _target(name)
        if not out.exists():
            pending[name] = (src, out)
    if not pending:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, out) in pending.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {name}.cu (exit "
                          f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        done[name] = (time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def load(name: str) -> ctypes.CDLL:
    """The compiled kernel library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _, out = _target(name)
            if not out.exists():
                build([name])
            lib = ctypes.CDLL(str(out))
            _loaded[name] = lib
        return lib
