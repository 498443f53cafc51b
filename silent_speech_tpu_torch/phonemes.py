"""The 48-phone inventory of the reference (``data_utils.py:17``) and the
frame-level phonemes of a Praat TextGrid.

Own copy of the JAX package's ``silent_speech_tpu/phonemes.py``: a
self-contained TextGrid parser (long and short text formats) in place of
the reference's ``praat-textgrids``, and ``read_phonemes`` with the
reference's frame mapping (``data_utils.py:223-241``): interval bounds to
frames at 86.133 a second (22050/256), stress digits stripped, ``''``,
``sp`` and ``spn`` as ``sil``; and the evaluation's report of the most
confused phoneme pairs (``print_confusion``).
"""

from __future__ import annotations

import re
import string
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

PHONEME_INVENTORY: List[str] = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ax', 'axr', 'ay', 'b', 'ch', 'd', 'dh',
    'dx', 'eh', 'el', 'em', 'en', 'er', 'ey', 'f', 'g', 'hh', 'hv', 'ih',
    'iy', 'jh', 'k', 'l', 'm', 'n', 'nx', 'ng', 'ow', 'oy', 'p', 'r', 's',
    'sh', 't', 'th', 'uh', 'uw', 'v', 'w', 'y', 'z', 'zh', 'sil',
]
SIL_ID = PHONEME_INVENTORY.index('sil')
NUM_PHONES = len(PHONEME_INVENTORY)
FRAMES_PER_SECOND = 86.133  # mel frame rate, 22050/256 (data_utils.py:225)


@dataclass
class Interval:
    xmin: float
    xmax: float
    text: str


def parse_textgrid(path_or_text: str, from_string: bool = False
                   ) -> Dict[str, List[Interval]]:
    """Parse a Praat TextGrid (long or short text format) into interval tiers.

    Only IntervalTier tiers are returned (point tiers are skipped); that is
    all MFA alignments contain.
    """
    if from_string:
        text = path_or_text
    else:
        with open(path_or_text, 'r', encoding='utf-8', errors='replace') as f:
            text = f.read()

    # Normalize: strip a UTF-8 BOM if present.
    text = text.lstrip('﻿')

    if 'item [' in text or 'item[' in text:
        return _parse_long_format(text)
    return _parse_short_format(text)


_NUM_RE = re.compile(r'[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?')
_QUOTED_RE = re.compile(r'"((?:[^"]|"")*)"')


def _parse_long_format(text: str) -> Dict[str, List[Interval]]:
    tiers: Dict[str, List[Interval]] = {}
    # Split into tier blocks at `item [n]:`
    blocks = re.split(r'item\s*\[\d+\]\s*:', text)
    for block in blocks[1:]:
        cls_m = re.search(r'class\s*=\s*"([^"]+)"', block)
        name_m = re.search(r'name\s*=\s*"([^"]*)"', block)
        if cls_m is None or name_m is None:
            continue
        if cls_m.group(1) != 'IntervalTier':
            continue
        intervals: List[Interval] = []
        for im in re.finditer(
            r'intervals\s*\[\d+\]\s*:\s*'
            r'xmin\s*=\s*([\d.eE+-]+)\s*'
            r'xmax\s*=\s*([\d.eE+-]+)\s*'
            r'text\s*=\s*"((?:[^"]|"")*)"',
            block,
        ):
            intervals.append(Interval(
                xmin=float(im.group(1)),
                xmax=float(im.group(2)),
                text=im.group(3).replace('""', '"'),
            ))
        tiers[name_m.group(1)] = intervals
    return tiers


def _parse_short_format(text: str) -> Dict[str, List[Interval]]:
    """Short TextGrid format: bare numbers and quoted strings, one per line."""
    tokens: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        qm = _QUOTED_RE.match(line)
        if qm is not None:
            tokens.append('"' + qm.group(1) + '"')
        else:
            nm = _NUM_RE.match(line)
            if nm is not None:
                tokens.append(nm.group(0))
    # Header: "ooTextFile" "TextGrid" xmin xmax <exists> ntiers
    tiers: Dict[str, List[Interval]] = {}
    i = 0
    # skip leading quoted header tokens
    while i < len(tokens) and tokens[i].startswith('"'):
        i += 1
    i += 2  # global xmin xmax
    if i >= len(tokens):
        return tiers
    ntiers = int(float(tokens[i])); i += 1
    for _ in range(ntiers):
        if i >= len(tokens):
            break
        cls = tokens[i].strip('"'); i += 1
        name = tokens[i].strip('"'); i += 1
        i += 2  # tier xmin xmax
        n = int(float(tokens[i])); i += 1
        intervals: List[Interval] = []
        if cls == 'IntervalTier':
            for _ in range(n):
                xmin = float(tokens[i]); xmax = float(tokens[i + 1])
                txt = tokens[i + 2].strip('"').replace('""', '"')
                intervals.append(Interval(xmin, xmax, txt))
                i += 3
            tiers[name] = intervals
        else:  # PointTier: number + mark per point
            i += 2 * n
    return tiers


def read_phonemes(textgrid_path: str, max_len: Optional[int] = None,
                  from_string: bool = False) -> np.ndarray:
    """Frame-level phoneme ids from an MFA TextGrid.

    Exact reference semantics (``data_utils.py:223-241``): the id array covers
    ``int(last_xmax * 86.133) + 1`` frames, each interval paints
    ``[int(xmin*fps), int(xmax*fps))``, the final frame is force-set to ``sil``
    before painting, stress digits are stripped, and missing coverage (or
    fewer than ``max_len`` frames) raises ``ValueError``.
    """
    tiers = parse_textgrid(textgrid_path, from_string=from_string)
    phones = tiers['phones']
    n = int(phones[-1].xmax * FRAMES_PER_SECOND) + 1
    phone_ids = np.full(n, -1, dtype=np.int64)
    phone_ids[-1] = SIL_ID
    for interval in phones:
        phone = interval.text.lower()
        if phone in ('', 'sp', 'spn'):
            phone = 'sil'
        if phone and phone[-1] in string.digits:
            phone = phone[:-1]
        ph_id = PHONEME_INVENTORY.index(phone)
        lo = int(interval.xmin * FRAMES_PER_SECOND)
        hi = int(interval.xmax * FRAMES_PER_SECOND)
        phone_ids[lo:hi] = ph_id
    if (phone_ids < 0).any():
        raise ValueError(f'{textgrid_path if not from_string else "TextGrid"}'
                         f': missing aligned phones')
    if max_len is not None:
        if phone_ids.shape[0] < max_len:
            raise ValueError(f'{phone_ids.shape[0]} aligned phone frames, '
                             f'fewer than the {max_len} asked for')
        phone_ids = phone_ids[:max_len]
    return phone_ids


def confusion_lines(confusion_mat: np.ndarray, n: int = 10) -> List[str]:
    """The report of ``print_confusion``: a header, then the top-n
    symmetric phoneme confusion pairs, each with the pair's accuracy
    (``data_utils.py:204-221``)."""
    target_counts = confusion_mat.sum(0) + 1e-4
    aslist = []
    for p1 in range(NUM_PHONES):
        for p2 in range(p1):
            aslist.append((
                (confusion_mat[p1, p2] + confusion_mat[p2, p1])
                / (target_counts[p1] + target_counts[p2]),
                p1, p2,
            ))
    aslist.sort()
    aslist = aslist[-n:]
    lines = ['Common confusions (confusion, accuracy)']
    for v, p1, p2 in aslist:
        acc = (confusion_mat[p1, p1] + confusion_mat[p2, p2]) / (
            target_counts[p1] + target_counts[p2])
        lines.append(
            f'{PHONEME_INVENTORY[p1]} {PHONEME_INVENTORY[p2]} '
            f'{v * 100:.1f} {acc * 100:.1f}')
    return lines


def print_confusion(confusion_mat: np.ndarray, n: int = 10) -> List[str]:
    """Print ``confusion_lines`` and return them."""
    lines = confusion_lines(confusion_mat, n)
    print('\n'.join(lines))
    return lines
