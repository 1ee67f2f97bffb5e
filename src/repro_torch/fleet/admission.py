"""Admission control: shed overload instead of thrashing the far tier.

The paper's Fig. 4 point is that pushing DDR past its utilization knee
explodes latency — the serving analogue is a backlog so deep that decode
steps queue behind far-tier migration traffic. The controller models each
request as (prefill + decode) token-equivalents of work, estimates the
fleet's service rate from its slot capacity, and admits only while the
projected queueing delay stays inside the SLO. Shed requests are counted,
not errored: an overloaded fleet degrades by rejecting at the door.

Multi-tenant: each tenant may carry its own ``SLOModel`` (a latency-tight
cache tenant sheds earlier than a throughput web tenant), and offered /
admitted are accounted per tenant so one tenant's burst shows up in *its*
shed rate, not its neighbors'. A tenant's own queued-but-undispatched work
is charged against its fair share of the fleet rate (``weight_share``), so
the projection a burst tenant sees inflates with its own backlog while
other tenants keep admitting against the shared engine backlog only.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

from repro_torch.data.requests import Request
from repro_torch.obs import MetricsRegistry


@dataclasses.dataclass
class SLOModel:
    """Delay budget in engine steps + how request tokens map to steps.

    A decode token costs one slot-step; prefill is amortized (one batched
    pass) so it is discounted by ``prefill_weight``.
    """

    max_delay_steps: float = 64.0
    prefill_weight: float = 0.25

    def request_cost(self, req: Request) -> float:
        return self.prefill_weight * len(req.tokens) + req.decode_len


class AdmissionController:
    def __init__(
        self,
        slo: SLOModel,
        tenant_slos: Optional[Dict[str, SLOModel]] = None,
        pressure_window: int = 64,
    ):
        self.slo = slo
        self.tenant_slos = dict(tenant_slos or {})
        self.offered = 0
        self.admitted = 0
        self.offered_by: Dict[str, int] = {}
        self.admitted_by: Dict[str, int] = {}
        # door books on the unified metrics plane (same ints as the dicts
        # above; the router folds this registry into the fleet merge)
        self.metrics = MetricsRegistry()
        # sliding window of recent admit/shed decisions, exported via
        # ``pressure()`` for observability. Note it only decays as NEW
        # offers arrive — the elastic fleet's scale decisions therefore use
        # interval deltas of offered/shed sampled at decision times
        # (fleet/elastic.py), which read zero once a burst ends.
        self._recent: deque = deque(maxlen=pressure_window)

    def slo_for(self, tenant: str) -> SLOModel:
        return self.tenant_slos.get(tenant, self.slo)

    @property
    def shed(self) -> int:
        return self.offered - self.admitted

    @property
    def shed_rate(self) -> float:
        return self.shed / max(self.offered, 1)

    def tenant_stats(self) -> Dict[str, dict]:
        out = {}
        for t, off in self.offered_by.items():
            adm = self.admitted_by.get(t, 0)
            out[t] = {
                "offered": off,
                "admitted": adm,
                "shed": off - adm,
                "shed_rate": (off - adm) / max(off, 1),
            }
        return out

    def fleet_rate(self, replicas: List) -> int:
        """Ideal service rate in tokens/step: total decode slots."""
        return sum(len(r.engine.slots) for r in replicas)

    @property
    def recent_shed_rate(self) -> float:
        """Shed fraction over the last ``pressure_window`` offers."""
        if not self._recent:
            return 0.0
        return 1.0 - sum(self._recent) / len(self._recent)

    def pressure(self, replicas: List) -> dict:
        """Scaling signal for fleet/elastic.py: how close the fleet is to
        shedding at the door. ``backlog_frac`` is projected queueing delay
        as a fraction of the default SLO budget — >1 means new arrivals are
        already over budget; ``shed_rate`` is the recent-window door rate.
        """
        backlog = self.backlog_steps(replicas)
        return {
            "shed_rate": self.recent_shed_rate,
            "backlog_steps": backlog,
            "backlog_frac": backlog / max(self.slo.max_delay_steps, 1e-9),
        }

    def backlog_steps(self, replicas: List) -> float:
        """Projected steps to drain the fleet's queued work at full rate.

        Queued prompts are discounted by the same ``prefill_weight`` as
        ``request_cost`` so admission and its SLO share one cost model.
        Chunk-aware via ``ServingEngine.backlog_tokens``: under chunked
        prefill a mid-prefill slot owes only its REMAINING chunk tokens,
        so pressure (and the elastic controller reading it) does not
        over-shed during long-prompt admission waves.
        """
        work = sum(r.engine.backlog_tokens(self.slo.prefill_weight) for r in replicas)
        return work / max(self.fleet_rate(replicas), 1)

    def admit(
        self,
        req: Request,
        replicas: List,
        tenant_backlog_tokens: float = 0.0,
        weight_share: float = 1.0,
    ) -> bool:
        """Admit/shed one request against its tenant's SLO.

        ``tenant_backlog_tokens`` is work the tenant has offered but the
        router has not yet dispatched; it drains at the tenant's weighted
        fair share of the fleet rate, not the whole rate.
        """
        tenant = getattr(req, "tenant", "default")
        self.offered += 1
        self.offered_by[tenant] = self.offered_by.get(tenant, 0) + 1
        self.metrics.counter("offered", tenant=tenant).inc()
        rate = self.fleet_rate(replicas)
        if rate <= 0:
            # no replicas / no decode slots: nothing can ever be served, so
            # everything sheds at the door (and no divide-by-zero below)
            self._recent.append(False)
            return False
        slo = self.slo_for(tenant)
        share_rate = rate * min(max(weight_share, 1e-9), 1.0)
        projected = (
            self.backlog_steps(replicas)
            + (tenant_backlog_tokens + slo.request_cost(req)) / share_rate
        )
        if projected > slo.max_delay_steps:
            self._recent.append(False)
            return False
        self.admitted += 1
        self.admitted_by[tenant] = self.admitted_by.get(tenant, 0) + 1
        self.metrics.counter("door_admitted", tenant=tenant).inc()
        self._recent.append(True)
        return True
