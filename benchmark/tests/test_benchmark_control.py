"""The comparison fails what it has to fail, at a size the CPU holds.

- The control: the reference computed in float8 (both operands of every
  product rounded to e4m3, their gradients to e5m2), put in the program's
  place, comes out not correct against each configuration's limits, at
  the published widths and depth with batches of ~260 frames (at cut
  widths the rounding of a product sums over fewer terms and the limits,
  set at the cells' size, do not apply); ~2 minutes on the CPU. The
  recognizer's control fails its ``head_gap`` on every seed.
- A run whose timed path is broken underneath, the harness's look for a
  card skipped and the rest of the run driven as on the card, comes out
  ``correct: false`` for each fault a training cell can have: a step that
  returns its state unchanged, and half of each batch left out with the
  mean taken over the rest. (The cells run on one card, so there is no
  exchange between cards to leave out, and a training step produces no
  token or answer to alter.)
"""

from __future__ import annotations

import pytest

from benchmark import checks, harness
from benchmark.tests import tiny

CELLS = ["transduction-train", "recognition-train"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = tiny.cell(cell, config=tiny.WIDE_CONFIG,
                  traffic=tiny.WIDE_TRAFFIC)
    module = harness.load_file(
        f"{harness.PACKAGE}/drivers/{c.config['entry']}.py",
        f"driver_{c.config['entry']}")
    limits = checks.load_limits(harness.PACKAGE, c.config_name)
    failed = 0
    for seed in (1, 2, 3):
        d = module.Driver(c.config, c.traffic, seed, "cpu")
        d.plan_compared()
        values = checks.numbers(d.reference("fp8"), d.reference(), d.accum)
        failed += not all(ok for *_, ok in checks.judge(values, limits))
        if "head_gap" in limits:
            # the number that separates the control from sound bf16 runs
            # of the recognizer at the cell's size, on every seed
            assert values["head_gap"] > limits["head_gap"]
    assert failed == 3


@pytest.mark.parametrize("cell", CELLS + ["transduction-train-voiced"])
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_step_is_not_correct(cell, fault):
    assert tiny.run(cell, fault=fault)["correct"] is False
