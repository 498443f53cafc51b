"""CLI: write a reference-schema split file (dev and test sentences) for a
corpus.

Counterpart of the JAX package's root ``make_testset.py``. The reference
ships fixed split files (``testset_largedev.json``: 200 dev / 100 test;
``testset_origdev.json``: 30 dev / 100 test) keyed by ``[book,
sentence_index]`` (``read_emg.py:151-154,179-184``); for a new or
synthetic corpus this draws the same schema from the discovered
utterance locations with ``random.Random(split_seed)``::

    python -m silent_speech_tpu_torch.make_testset \\
        --silent_data_directories DIR --voiced_data_directories DIR \\
        --testset_file out.json --dev_size 200 --test_size 100 \\
        --split_seed 0

It reads the corpus's ``_info.json`` files and touches no device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import random
import re
import sys
from typing import Optional, Sequence

from .flags import add_data_flags, add_flag, data_config_from_args


def discover_locations(directories):
    """Every distinct [book, sentence_index] across the session
    directories, in discovery order (the dataset's rule,
    ``read_emg.py:171-188``; boundary clips of index −1 left out)."""
    locations = []
    seen = set()
    for root in directories:
        for session in sorted(os.listdir(root)):
            d = os.path.join(root, session)
            for fname in sorted(os.listdir(d)):
                if re.match(r"\d+_info.json", fname) is None:
                    continue
                with open(os.path.join(d, fname)) as f:
                    info = json.load(f)
                if info["sentence_index"] < 0:
                    continue
                loc = (info["book"], info["sentence_index"])
                if loc not in seen:
                    seen.add(loc)
                    locations.append(list(loc))
    return locations


def make_split(locations, dev_size, test_size, seed):
    """``{"dev": [...], "test": [...]}``: a seeded sample of the
    locations, the first ``dev_size`` to dev and the rest to test."""
    rng = random.Random(seed)
    picked = rng.sample(range(len(locations)),
                        min(dev_size + test_size, len(locations)))
    dev = [locations[i] for i in picked[:dev_size]]
    test = [locations[i] for i in picked[dev_size:]]
    return {"dev": dev, "test": test}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Write a dev/test split file "
                                 "for a corpus (PyTorch port).")
    flag = functools.partial(add_flag, ap)
    add_data_flags(flag)
    flag("dev_size", 200, "dev-set sentence count (largedev uses 200, "
         "origdev 30)")
    flag("test_size", 100, "test-set sentence count")
    flag("split_seed", 0, "sampling seed")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    cfg = data_config_from_args(args)
    locations = discover_locations(list(cfg.silent_data_directories)
                                   + list(cfg.voiced_data_directories))
    split = make_split(locations, args.dev_size, args.test_size,
                       args.split_seed)
    if (len(split["dev"]) < args.dev_size
            or len(split["test"]) < args.test_size):
        print(f"WARNING: only {len(locations)} locations available — "
              f"requested {args.dev_size} dev + {args.test_size} test; the "
              "train split will be small or empty", file=sys.stderr)
    with open(cfg.testset_file, "w") as f:
        json.dump(split, f)
    print(f"wrote {cfg.testset_file}: {len(split['dev'])} dev / "
          f"{len(split['test'])} test of {len(locations)} locations")
    return split


if __name__ == "__main__":
    main()
