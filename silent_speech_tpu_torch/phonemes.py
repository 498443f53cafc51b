"""The 48-phone inventory of the reference (``data_utils.py:17``); the
transduction loss uses its size for the phoneme head and the confusion
matrix."""

from __future__ import annotations

from typing import List

PHONEME_INVENTORY: List[str] = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ax', 'axr', 'ay', 'b', 'ch', 'd', 'dh',
    'dx', 'eh', 'el', 'em', 'en', 'er', 'ey', 'f', 'g', 'hh', 'hv', 'ih',
    'iy', 'jh', 'k', 'l', 'm', 'n', 'nx', 'ng', 'ow', 'oy', 'p', 'r', 's',
    'sh', 't', 'th', 'uh', 'uw', 'v', 'w', 'y', 'z', 'zh', 'sil',
]
NUM_PHONES = len(PHONEME_INVENTORY)
