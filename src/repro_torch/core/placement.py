"""TPP-like page placement: promotion/demotion between near and far tiers.

The paper's Tiered config uses Maruf et al.'s Transparent Page Placement;
this is that loop for framework state blocks: windowed access counts drive
promotions of hot far-tier blocks and demotions of cold near-tier blocks,
under a per-step migration budget (migration traffic competes with demand
traffic — the paper's Fig. 20 warm-up transient is exactly this budget).

Hysteresis: a far block must beat the coldest near block by ``hysteresis``x
to be promoted, so ping-pong migrations don't eat the budget.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PlacementStats:
    promotions: int = 0
    demotions: int = 0
    near_hits: int = 0
    far_hits: int = 0
    migrated_bytes: int = 0

    @property
    def hit_rate(self) -> float:
        tot = self.near_hits + self.far_hits
        return self.near_hits / max(tot, 1)


class TieredPlacement:
    def __init__(
        self,
        n_blocks: int,
        near_capacity: int,
        block_bytes: int = 4096,
        hysteresis: float = 1.25,
        migrate_budget: int = 64,
    ):
        assert 0 < near_capacity
        self.n_blocks = n_blocks
        self.near_capacity = min(near_capacity, n_blocks)
        self.block_bytes = block_bytes
        self.hysteresis = hysteresis
        self.migrate_budget = migrate_budget
        self.tier = np.ones(n_blocks, np.int8)  # 0 = near, 1 = far
        self.tier[: self.near_capacity] = 0  # initial arbitrary fill
        self.stats = PlacementStats()

    # ------------------------------------------------------------------
    def near_blocks(self) -> np.ndarray:
        return np.flatnonzero(self.tier == 0)

    def access(self, block_ids: np.ndarray):
        """Account demand accesses (near vs far hits)."""
        t = self.tier[np.asarray(block_ids).reshape(-1)]
        near = int((t == 0).sum())
        self.stats.near_hits += near
        self.stats.far_hits += t.size - near

    def plan_initial(self, counts: np.ndarray):
        """Profile-driven cold start: hottest blocks straight to near tier."""
        order = np.argsort(-np.asarray(counts))
        self.tier[:] = 1
        self.tier[order[: self.near_capacity]] = 0

    def step(self, window_counts: np.ndarray) -> dict:
        """One TPP epoch: promote/demote using the last window's counts."""
        counts = np.asarray(window_counts, np.float64)
        near = np.flatnonzero(self.tier == 0)
        far = np.flatnonzero(self.tier == 1)
        if near.size == 0 or far.size == 0:
            return {"promoted": 0, "demoted": 0}
        order_far = far[np.argsort(-counts[far])]
        order_near = near[np.argsort(counts[near])]
        promoted = demoted = 0
        budget = self.migrate_budget
        for cand, victim in zip(order_far, order_near):
            if budget <= 0:
                break
            if counts[cand] > self.hysteresis * counts[victim] and counts[cand] > 0:
                self.tier[cand] = 0
                self.tier[victim] = 1
                promoted += 1
                demoted += 1
                budget -= 2
            else:
                break  # sorted orders: no further pair can qualify
        self.stats.promotions += promoted
        self.stats.demotions += demoted
        self.stats.migrated_bytes += (promoted + demoted) * self.block_bytes
        return {"promoted": promoted, "demoted": demoted}
