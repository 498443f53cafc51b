"""The comparison that decides ``correct``.

The numbers, each read from the program's first updates against the
reference's (``reference/train.py``):

- ``loss_gap``: the largest of |L_program − L_reference| / |L_reference|
  over the micro-steps of the first update, which both sides compute from
  the same weights; the later micro-steps' losses are read too
  (``loss_gap_all``) and held to nothing: after an update each side
  follows its own trajectory, and a recognizer's CTC loss that falls from
  ~38 to ~5 in two updates turns the rounding of the first into gaps of up
  to 31% by the fifth micro-step;
- ``grad_gap``: over the leaves, the widest gap between the program's
  norm of the first update's gradient (worked out from its first moment,
  m₁ / (1 − β₁)) and the reference's, measured against the reference's
  norm of that leaf or of the median leaf, whichever is larger;
- ``grad_gap_median``: the median leaf's gap of the same, over the leaves
  below;
- ``head_gap``: the first micro-step's output head (a recognizer's
  logits, a transducer's mel frames), before any loss and from the same
  weights and draws on both sides, at the rows of the batch's real
  frames: ‖H_program − H_reference‖ / ‖H_reference‖ over all of them. It
  reads the forward's rounding alone, before a loss (the CTC's alignment
  posteriors) can amplify it;
- ``change_gap``: the widest gap of the same kind between the norms of
  each leaf's change of weights after the last compared update, over the
  leaves whose reference gradient is not nought to rounding: a leaf whose
  gradient norm is under a thousandth of the median leaf's (a bias before
  a BatchNorm, whose gradient is zero but for rounding) moves under Adam by
  round-off alone, and is left out by that rule, not by name.

Which numbers a configuration holds to a limit, and each limit with the
readings it was set from and why, is in its limits file
(``reference/limits/<config>.json``); the others are reported as
readings. A compared number that is not finite fails. ``correct`` is
every compared number within its limit.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np

NOUGHT = 1e-3   # of the median leaf's gradient norm


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves) -> Dict[str, float]:
    """Each leaf's gap of norms, against the reference's norm of the leaf
    or of the median leaf, whichever is larger."""
    median = float(np.median([reference[n] for n in leaves]))
    return {n: abs(program[n] - reference[n]) / max(reference[n], median)
            for n in leaves}


def _worst(gaps: Dict[str, float]):
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def numbers(program, reference, first: int) -> Dict[str, float]:
    """The numbers of a program's readings against the
    reference's (both ``reference.train.Readings``); ``first`` is the
    number of micro-steps of an update."""
    gaps = [abs(p - r) / abs(r)
            for p, r in zip(program.losses, reference.losses)]
    loss = max(gaps[:first])
    names = sorted(reference.grad_norms)
    grads = leaf_gaps(program.grad_norms, reference.grad_norms, names)
    median_g = float(np.median([reference.grad_norms[n] for n in names]))
    moving = [n for n in names
              if reference.grad_norms[n] >= NOUGHT * median_g]
    changes = leaf_gaps(program.change_norms, reference.change_norms,
                         moving)
    head = float("inf")
    if program.head is not None and reference.head is not None and \
            program.head.shape == reference.head.shape:
        ref = reference.head.double()
        head = float((program.head.double() - ref).norm() / ref.norm())
    grad, grad_leaf = _worst(grads)
    change, change_leaf = _worst(changes)
    moving_grads = {n: grads[n] for n in moving}
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "head_gap": head,
            # readings beside the compared numbers, for the record
            "loss_gap_all": max(gaps), "grad_leaf": grad_leaf,
            "grad_gap_moving": _worst(moving_grads)[0],
            "grad_leaf_moving": _worst(moving_grads)[1],
            "grad_gap_median": float(np.median(list(moving_grads.values()))),
            "change_leaf": change_leaf,
            "change_gap_median": float(np.median(list(changes.values())))}


def limits_path(root: str, config_name: str) -> str:
    return os.path.join(root, "reference", "limits", f"{config_name}.json")


def load_limits(root: str, config_name: str) -> Dict[str, float]:
    """The compared numbers of a configuration and their limits."""
    with open(limits_path(root, config_name)) as f:
        spec = json.load(f)
    return {name: float(entry["limit"]) for name, entry in spec.items()
            if "limit" in entry}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> List:
    """[(name, value, limit, within)] of each compared number."""
    return [(name, values[name], limit,
             math.isfinite(values[name]) and values[name] <= limit)
            for name, limit in limits.items()]
