"""Exact solver for the SilentZNS zone-allocation integer program (paper §5).

The ILP (Eqs. 1-6):

    minimize   sum_n c_n * w_n
    subject to c_n = 0 unless a_n in {0, 3}              (availability)
               sum_n c_n = Z                             (zone size)
               s_l <= sum_{n in LUN l} c_n <= K * s_l    (coupling)
               sum_l s_l >= L_min                        (parallelism)
               s_l = 0 for l not in L_elig               (round-robin)

Key structure: once the *count* j_l of elements taken from each group l is
fixed, the optimum takes the j_l lowest-wear available elements of that
group.  So the ILP reduces to choosing counts {j_l}, which we solve with an
exact dynamic program over groups:

    dp[g][z][a] = min cost using the first g groups, z elements selected,
                  a active groups.

This is O(G * Z^2 * G) worst case -- tiny for device-scale instances and
used as the *oracle* in tests for both the vectorized JAX allocator and the
Pallas ``zns_alloc`` kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

INF = float("inf")

#: availability codes (paper §5): 0 free, 1 allocated-empty, 2 valid data,
#: 3 invalid data (free for re-allocation after erase).
AVAIL_FREE = 0
AVAIL_ALLOCATED = 1
AVAIL_VALID = 2
AVAIL_INVALID = 3

ALLOCATABLE = (AVAIL_FREE, AVAIL_INVALID)


@dataclasses.dataclass
class ExactSolution:
    cost: float
    selected: np.ndarray        # element ids, sorted
    counts_per_group: np.ndarray
    feasible: bool


def solve(wear: np.ndarray,
          avail: np.ndarray,
          group: np.ndarray,
          *,
          z: int,
          k_max: int,
          l_min: int,
          eligible_groups: Sequence[int]) -> ExactSolution:
    """Solve the allocation ILP exactly. Arrays are 1-D over elements."""
    wear = np.asarray(wear, dtype=np.float64)
    avail = np.asarray(avail)
    group = np.asarray(group)
    n_groups = int(group.max()) + 1 if group.size else 0
    eligible = sorted(set(int(g) for g in eligible_groups))

    # Per-eligible-group sorted available wears + element ids.
    per_group_sorted: List[np.ndarray] = []
    per_group_ids: List[np.ndarray] = []
    for g in eligible:
        ok = (group == g) & np.isin(avail, ALLOCATABLE)
        ids = np.nonzero(ok)[0]
        order = np.argsort(wear[ids], kind="stable")
        per_group_sorted.append(wear[ids][order])
        per_group_ids.append(ids[order])

    G = len(eligible)
    # prefix[g][j] = cost of taking the j cheapest from group g
    prefix = []
    for ws in per_group_sorted:
        j_max = min(k_max, len(ws))
        p = np.zeros(j_max + 1)
        p[1:] = np.cumsum(ws[:j_max])
        prefix.append(p)

    # dp[z][a] over groups
    dp = np.full((z + 1, G + 1), INF)
    dp[0][0] = 0.0
    choice = np.full((G, z + 1, G + 1), -1, dtype=np.int64)
    for gi in range(G):
        ndp = np.full_like(dp, INF)
        jmax = len(prefix[gi]) - 1
        for zz in range(z + 1):
            for aa in range(G + 1):
                if dp[zz][aa] == INF:
                    continue
                for j in range(0, min(jmax, z - zz) + 1):
                    na = aa + (1 if j > 0 else 0)
                    c = dp[zz][aa] + prefix[gi][j]
                    if c < ndp[zz + j][na]:
                        ndp[zz + j][na] = c
                        choice[gi][zz + j][na] = j
        dp = ndp

    best_a, best_cost = -1, INF
    for aa in range(l_min, G + 1):
        if dp[z][aa] < best_cost:
            best_cost = dp[z][aa]
            best_a = aa
    if best_a < 0:
        return ExactSolution(INF, np.empty(0, np.int64),
                             np.zeros(G, np.int64), False)

    # backtrack
    counts = np.zeros(G, dtype=np.int64)
    zz, aa = z, best_a
    for gi in range(G - 1, -1, -1):
        j = int(choice[gi][zz][aa])
        counts[gi] = j
        zz -= j
        aa -= 1 if j > 0 else 0
    selected = np.concatenate(
        [per_group_ids[gi][: counts[gi]] for gi in range(G)]
        or [np.empty(0, np.int64)])
    return ExactSolution(float(best_cost), np.sort(selected),
                         counts, True)


def solve_even(wear: np.ndarray, avail: np.ndarray, group: np.ndarray, *,
               take_per_group: int,
               eligible_groups: Sequence[int]) -> ExactSolution:
    """The balanced special case used by every paper configuration: take
    exactly ``take_per_group`` lowest-wear elements from each eligible
    group (equivalent to the ILP with K = take = Z / |L_elig| and
    L_min = |L_elig|)."""
    wear = np.asarray(wear, dtype=np.float64)
    sel: List[np.ndarray] = []
    cost = 0.0
    feasible = True
    counts = []
    for g in eligible_groups:
        ok = (group == g) & np.isin(avail, ALLOCATABLE)
        ids = np.nonzero(ok)[0]
        if len(ids) < take_per_group:
            feasible = False
            counts.append(len(ids))
            continue
        order = np.argsort(wear[ids], kind="stable")[:take_per_group]
        sel.append(ids[order])
        cost += float(wear[ids][order].sum())
        counts.append(take_per_group)
    selected = (np.sort(np.concatenate(sel)) if sel
                else np.empty(0, np.int64))
    return ExactSolution(cost if feasible else INF, selected,
                         np.asarray(counts), feasible)
