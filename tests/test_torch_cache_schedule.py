"""The port's copy of the refresh-schedule module (plain numpy) against
stedm_tpu/core/cache_schedule.py on every spec form, and the guidance
window's scan positions against stedm_tpu's ``guided_range``. Exact
equality: both are the same integer and float64 arithmetic."""

from pathlib import Path

import numpy as np
import pytest

from stedm_tpu.core import cache_schedule as jcs
from stedm_tpu.core.ddim import guided_range as jguided_range
from stedm_tpu_torch.core import cache_schedule as cs
from stedm_tpu_torch.core.ddim import guided_range

DRIFT = np.load(Path(__file__).resolve().parents[1] / "tools" / "bench_assets"
                / "drift_untrained_flagship.npy")

SPECS = [(0, 7, 3), "0,3,7,12", "12,0,3,3", "uniform:5", "uniform:1", "quad:13",
         "quad:6:0.5", "quad:9:0.2:2.0", "quad:50", "auto:5", "auto:1", "auto:13"]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_positions_from_spec_match_jax(spec):
    assert cs.positions_from_spec(spec, 50, DRIFT) == jcs.positions_from_spec(spec, 50, DRIFT)


def test_bench_headline_schedule_and_window():
    """bench.py's serving mode: auto:5 on the committed drift profile, and the
    (0.35, 0.65) window at 50 steps (Python's round takes 17.5 to 18 and 32.5
    to 32)."""
    assert DRIFT.shape == (49,) and DRIFT.dtype == np.float64
    assert cs.positions_from_spec("auto:5", 50, DRIFT) == (0, 3, 21, 33, 41)
    assert guided_range(50, (0.35, 0.65)) == jguided_range(50, (0.35, 0.65)) == (18, 32)


@pytest.mark.parametrize("steps,window", [(8, (0.25, 0.75)), (7, (0.5, 0.5)), (10, None),
                                          (9, (0.0, 1.0)), (6, (0.1, 0.9))])
def test_guided_range_matches_jax(steps, window):
    assert guided_range(steps, window) == jguided_range(steps, window)


@pytest.mark.parametrize("spec,drift", [((3, 5), DRIFT), ("", DRIFT), ("0,50", DRIFT),
                                        ("auto:5", None), ("auto:5", DRIFT[:10]),
                                        ("uniform:0", DRIFT), ("quad:0", DRIFT),
                                        ("quad:3:1.5", DRIFT)])
def test_refusals_match_jax(spec, drift):
    with pytest.raises(ValueError) as jerr:
        jcs.positions_from_spec(spec, 50, drift)
    with pytest.raises(ValueError) as err:
        cs.positions_from_spec(spec, 50, drift)
    assert str(err.value) == str(jerr.value)


def test_coalesce_cost_and_optimum_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        steps = int(rng.integers(8, 40))
        drift = rng.uniform(0, 1, steps - 1)
        pos = tuple(sorted({0, *rng.integers(1, steps, 4).tolist()}))
        for budget in (1, 3, 10):
            assert cs.coalesce_blocks(pos, steps, budget) == jcs.coalesce_blocks(pos, steps,
                                                                                 budget)
        assert cs.schedule_cost(pos, drift) == jcs.schedule_cost(pos, drift)
        for r in (1, 3, 6):
            assert cs.optimal_positions(drift, r) == jcs.optimal_positions(drift, r)
        assert cs.quad_center_positions(steps, 5) == jcs.quad_center_positions(steps, 5)
        assert cs.uniform_positions(steps, 4) == jcs.uniform_positions(steps, 4)
