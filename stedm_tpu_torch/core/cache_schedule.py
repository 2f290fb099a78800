"""Refresh schedules of the serving mode's deep-feature cache: a copy of
stedm_tpu/core/cache_schedule.py (plain numpy), kept here so that the port
imports nothing of the JAX package.

The serving mode refreshes the deep U-Net trunk on a subset of DDIM steps and
runs the cheap shallow path in between. Constructors:

* :func:`uniform_positions` -- every Nth step (what ``cache_interval`` does);
* :func:`quad_center_positions` -- spacing densest around a chosen step;
* :func:`optimal_positions` -- the exact minimiser, by dynamic programming,
  of the accumulated staleness for a measured per-step drift profile.

Positions are in **scan order**: position 0 is the highest-noise step and
must always be a refresh (there is no cache yet). The drift profile comes
from :func:`stedm_tpu_torch.train.calibrate.measure_cache_drift`. If step k
runs shallow against a cache refreshed at step r < k, its staleness is
``sum(d[r+1..k])``; a schedule costs that summed over its shallow steps.
"""

from __future__ import annotations

import numpy as np


def positions_from_spec(spec, num_steps: int,
                        drift: np.ndarray | None = None) -> tuple[int, ...]:
    """Parse a user-facing refresh-schedule spec into positions.

    Accepted forms (CLI surface for ``+cache_schedule=``):

    * a sequence of ints, or a comma string ``"0,3,7,12"`` — explicit positions;
    * ``"uniform:N"`` — every Nth step (placement-equal to ``cache_interval=N``);
    * ``"quad:R[:center[:power]]"`` — R refreshes, densest at ``center`` (default
      0.35) with tail ``power`` (default 1.3);
    * ``"auto:R"`` — R refreshes placed optimally for a measured ``drift``
      profile (from `stedm_tpu_torch.train.calibrate.measure_cache_drift`).
    """
    if not isinstance(spec, str):
        return validate_positions(list(spec), num_steps)
    kind, _, rest = spec.partition(":")
    if kind == "uniform":
        return uniform_positions(num_steps, int(rest))
    if kind == "quad":
        parts = rest.split(":")
        n = int(parts[0])
        center = float(parts[1]) if len(parts) > 1 else 0.35
        power = float(parts[2]) if len(parts) > 2 else 1.3
        return quad_center_positions(num_steps, n, center, power)
    if kind == "auto":
        if drift is None:
            raise ValueError("cache_schedule 'auto:R' needs a measured drift "
                             "profile (run calibration first)")
        if len(drift) != num_steps - 1:
            raise ValueError(f"drift profile length {len(drift)} does not match "
                             f"{num_steps} sampler steps")
        return optimal_positions(drift, int(rest))
    return validate_positions([int(p) for p in spec.split(",")], num_steps)


def validate_positions(positions, num_steps: int) -> tuple[int, ...]:
    """Canonicalize a refresh schedule: sorted, unique, in range, starting at 0."""
    pos = sorted(set(int(p) for p in positions))
    if not pos:
        raise ValueError("refresh schedule is empty")
    if pos[0] != 0:
        raise ValueError("refresh schedule must include position 0 (the first, "
                         f"highest-noise step has no cache to reuse): {pos}")
    if pos[-1] >= num_steps or pos[0] < 0:
        raise ValueError(f"refresh positions {pos} out of range for "
                         f"{num_steps} steps")
    return tuple(pos)


def uniform_positions(num_steps: int, interval: int) -> tuple[int, ...]:
    """Every ``interval``-th step — identical placement to ``cache_interval``."""
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    return tuple(range(0, num_steps, interval))


def quad_center_positions(num_steps: int, n_refresh: int, center: float = 0.35,
                          power: float = 1.3) -> tuple[int, ...]:
    """Non-uniform spacing, densest around ``center`` (fraction of the
    trajectory, scan order). ``power`` > 1 widens the sparse tails.

    Construction: place ``n_refresh`` points u_i uniformly in [-1, 1], warp each
    by sign(u)*|u|^power (concentrating points near 0), then map 0 -> center.
    Collisions after rounding are resolved by sliding to the nearest free step,
    so exactly ``n_refresh`` distinct positions are returned (when they fit).
    """
    if not 0.0 <= center <= 1.0:
        raise ValueError(f"center must be in [0, 1], got {center}")
    if n_refresh < 1 or n_refresh > num_steps:
        raise ValueError(f"n_refresh={n_refresh} out of range for {num_steps} steps")
    u = np.linspace(-1.0, 1.0, n_refresh)
    warped = np.sign(u) * np.abs(u) ** power          # in [-1, 1], dense near 0
    c = center * (num_steps - 1)
    span = max(c, (num_steps - 1) - c)                # cover the whole range
    raw = np.clip(c + warped * span, 0, num_steps - 1)
    taken: set[int] = set()
    for p in sorted(raw):
        q = int(round(p))
        step = 0
        while True:                                    # nearest free slot
            for cand in (q - step, q + step):
                if 0 <= cand < num_steps and cand not in taken:
                    taken.add(cand)
                    break
            else:
                step += 1
                continue
            break
    pos = sorted(taken)
    if pos[0] != 0:                                    # force the mandatory first refresh
        taken.discard(pos[0])
        taken.add(0)
    return validate_positions(taken, num_steps)


def coalesce_blocks(positions, num_steps: int, budget: int) -> list[int]:
    """Greedy host-block partition of a refresh schedule: merge consecutive
    refresh periods into one dispatch block while the block stays within
    ``budget`` steps. Returns the block start positions (a subset of the
    refresh positions, always beginning at 0).

    Used by the block sampler (`train/host_sampler.py`): every
    block must START at a refresh (the in-block cache begins empty), so block
    boundaries can only sit on refresh positions; a single period longer than
    the budget becomes its own (oversized) block.
    """
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    pos = list(validate_positions(positions, num_steps))
    bounds = pos + [num_steps]
    starts = [0]
    for i in range(1, len(pos)):
        if bounds[i + 1] - starts[-1] > budget:
            starts.append(pos[i])
    return starts


def schedule_cost(positions, drift: np.ndarray) -> float:
    """Accumulated-staleness proxy of a schedule under a drift profile.

    ``drift[k]`` (length S-1) is the trunk-feature movement between steps k and
    k+1. A shallow step k reusing a cache from refresh r costs
    ``sum(drift[r:k])``; refresh steps cost 0.
    """
    num_steps = len(drift) + 1
    pos = validate_positions(positions, num_steps)
    cum = np.concatenate([[0.0], np.cumsum(np.asarray(drift, np.float64))])
    cost = 0.0
    refresh = set(pos)
    r = 0
    for k in range(num_steps):
        if k in refresh:
            r = k
        else:
            cost += cum[k] - cum[r]
    return float(cost)


def optimal_positions(drift: np.ndarray, n_refresh: int) -> tuple[int, ...]:
    """Exact optimal placement of ``n_refresh`` refreshes for ``drift`` (DP).

    Minimizes :func:`schedule_cost`. ``drift`` has length S-1 for an S-step
    trajectory. Runs in O(S^2 * R) — trivial at DDIM step counts.
    """
    drift = np.asarray(drift, np.float64)
    S = len(drift) + 1
    if n_refresh < 1 or n_refresh > S:
        raise ValueError(f"n_refresh={n_refresh} out of range for {S} steps")
    cum = np.concatenate([[0.0], np.cumsum(drift)])
    # seg_cost[r][e] = cost of steps r..e-1 all reusing a refresh at r
    # = sum_{k=r+1}^{e-1} (cum[k] - cum[r])
    cum2 = np.concatenate([[0.0], np.cumsum(cum)])    # prefix sums of cum

    def seg_cost(r: int, e: int) -> float:
        # sum(cum[r+1..e-1]) - (e-1-r)*cum[r]
        return (cum2[e] - cum2[r + 1]) - (e - 1 - r) * cum[r]

    INF = float("inf")
    # best[j][e] = min cost of covering steps [0, e) with j refreshes, the last
    # refresh anywhere in [j-1, e)
    best = np.full((n_refresh + 1, S + 1), INF)
    arg = np.zeros((n_refresh + 1, S + 1), np.int64)
    best[0][0] = 0.0
    for j in range(1, n_refresh + 1):
        for e in range(j, S + 1):
            for r in range(j - 1, e):                  # last refresh position
                c = best[j - 1][r] + seg_cost(r, e)
                if c < best[j][e]:
                    best[j][e] = c
                    arg[j][e] = r
    # backtrack
    pos = []
    e = S
    for j in range(n_refresh, 0, -1):
        r = int(arg[j][e])
        pos.append(r)
        e = r
    return validate_positions(pos, S)
