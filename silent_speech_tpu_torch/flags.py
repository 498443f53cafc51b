"""The port's command-line flags in the JAX CLIs' forms, parsed with
argparse: booleans take ``--name``, ``--noname`` and
``--name=false``; lists are comma-separated. The dataset's flags, shared by
every CLI that reads a corpus, carry the JAX package's names and defaults
(``silent_speech_tpu/config.py``; reference ``read_emg.py:21-25``,
``data_utils.py:15``)."""

from __future__ import annotations

import argparse

from .config import DataConfig, MeshConfig


def _bool(value: str) -> bool:
    v = value.lower()
    if v in ("1", "true", "t", "yes", "y"):
        return True
    if v in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {value!r}")


def _list(value: str):
    return [v for v in value.split(",") if v]


def add_flag(ap: argparse.ArgumentParser, name: str, default, help_: str,
             type_=None) -> None:
    """``--name`` with the JAX CLI's forms: a boolean also takes
    ``--noname`` and ``--name=false``."""
    if type_ is _bool:
        ap.add_argument(f"--{name}", nargs="?", const=True,
                        default=default, type=_bool, help=help_)
        ap.add_argument(f"--no{name}", dest=name, action="store_false",
                        help=argparse.SUPPRESS)
    else:
        ap.add_argument(f"--{name}", default=default,
                        type=type_ or type(default), help=help_)


def add_data_flags(flag) -> None:
    """The corpus's flags, through ``flag`` (``add_flag`` bound to a
    parser)."""
    d = DataConfig()
    flag("remove_channels", d.remove_channels, "channels to remove", _list)
    flag("silent_data_directories", d.silent_data_directories,
         "silent data locations", _list)
    flag("voiced_data_directories", d.voiced_data_directories,
         "voiced data locations", _list)
    flag("testset_file", d.testset_file, "file with testset indices")
    flag("text_align_directory", d.text_align_directory,
         "alignment file directory")
    flag("normalizers_file", d.normalizers_file,
         "pickled feature normalizers")


def add_mesh_flags(flag) -> None:
    """``--model_parallel``, the JAX CLIs' flag; the data axis takes the
    rest of ``torchrun``'s ranks."""
    flag("model_parallel", MeshConfig().model_parallel,
         "size of the model (tensor-parallel) mesh axis")


def cli_mesh(args, device):
    """The CLI's mesh: under ``torchrun`` (``WORLD_SIZE`` set) or with
    ``--model_parallel`` above 1, ``make_mesh(-1, model_parallel)`` on
    ``device``'s kind; otherwise None, one process without collectives."""
    import os

    if "WORLD_SIZE" not in os.environ and args.model_parallel == 1:
        return None
    from .parallel.mesh import make_mesh

    return make_mesh(-1, args.model_parallel, device)


def data_config_from_args(args, **kw) -> DataConfig:
    """The ``DataConfig`` of ``add_data_flags``' flags, plus ``kw``."""
    return DataConfig(
        remove_channels=[int(c) for c in args.remove_channels],
        silent_data_directories=list(args.silent_data_directories),
        voiced_data_directories=list(args.voiced_data_directories),
        testset_file=args.testset_file,
        text_align_directory=args.text_align_directory,
        normalizers_file=args.normalizers_file, **kw)
