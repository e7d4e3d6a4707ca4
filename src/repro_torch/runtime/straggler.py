"""Straggler bookkeeping: detect a step (or tile) whose duration blows
past a deadline derived from the running EWMA, and hosts that stay slower
than their peers.

The serving engine feeds it per-tile in-flight latencies and, on a
``deadline_exceeded`` verdict, abandons the slow tile and redispatches it
instead of paying the stall. Pure Python. A copy of the reference
package's ``runtime.straggler``; the port imports nothing of the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class StragglerConfig:
    ewma_alpha: float = 0.05        # step-time smoothing
    deadline_factor: float = 3.0    # step deadline = factor * ewma
    slow_factor: float = 1.5        # host is "slow" above this x median
    evict_after: int = 20           # consecutive slow steps before eviction
    warmup_steps: int = 10          # ignore compile/first-step noise


@dataclass
class HostStats:
    ewma: float = 0.0
    slow_streak: int = 0
    n: int = 0


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.hosts: Dict[int, HostStats] = {}
        self.global_ewma: float = 0.0
        self.n_steps: int = 0
        self.events: list = []

    # ------------------------------------------------------------ feed -----
    def record_step(self, duration_s: float,
                    per_host: Optional[Dict[int, float]] = None) -> dict:
        """Feed one step's timing. Returns verdict dict:
        {deadline_exceeded, slow_hosts, evict_hosts, deadline_s}."""
        self.n_steps += 1
        warm = self.n_steps <= self.cfg.warmup_steps
        a = self.cfg.ewma_alpha
        if self.global_ewma == 0.0:
            self.global_ewma = duration_s
        elif not warm:
            self.global_ewma = (1 - a) * self.global_ewma + a * duration_s
        deadline = self.cfg.deadline_factor * self.global_ewma
        verdict = {"deadline_exceeded": (not warm) and duration_s > deadline,
                   "deadline_s": deadline, "slow_hosts": [],
                   "evict_hosts": []}

        if per_host:
            med = _median(list(per_host.values()))
            for h, d in per_host.items():
                st = self.hosts.setdefault(h, HostStats())
                st.n += 1
                st.ewma = d if st.ewma == 0 else (1 - a) * st.ewma + a * d
                if not warm and d > self.cfg.slow_factor * med:
                    st.slow_streak += 1
                    verdict["slow_hosts"].append(h)
                else:
                    st.slow_streak = 0
                if st.slow_streak >= self.cfg.evict_after:
                    verdict["evict_hosts"].append(h)
        if verdict["deadline_exceeded"]:
            self.events.append(("deadline", self.n_steps, duration_s))
        for h in verdict["evict_hosts"]:
            self.events.append(("evict", self.n_steps, h))
        return verdict

    # -------------------------------------------- host-level flagging -----
    def record_host_step(self, host, duration_s: float) -> None:
        """Feed ONE host's service sample outside the global step path —
        the serving cluster's per-host service EWMA (each host drains its
        own tiles on its own cadence, so there is no single step that
        covers all hosts the way ``record_step(per_host=...)`` assumes).
        Slow-streak/eviction verdicts stay with ``record_step``; this
        site only maintains the EWMA that ``slow_hosts`` compares."""
        a = self.cfg.ewma_alpha
        st = self.hosts.setdefault(host, HostStats())
        st.n += 1
        st.ewma = (duration_s if st.ewma == 0
                   else (1 - a) * st.ewma + a * duration_s)

    def host_ewma(self, host) -> float:
        st = self.hosts.get(host)
        return st.ewma if st else 0.0

    def slow_hosts(self) -> list:
        """Hosts whose service EWMA exceeds ``slow_factor`` x the median
        host EWMA — the cluster marks these ``suspect`` (deprioritized
        for placement, still served). Needs >= 2 hosts with samples: a
        lone host has no peer to be slow relative to."""
        ewmas = {h: s.ewma for h, s in self.hosts.items() if s.ewma > 0}
        if len(ewmas) < 2:
            return []
        med = _median(list(ewmas.values()))
        return [h for h, e in ewmas.items()
                if e > self.cfg.slow_factor * med]

    def summary(self) -> dict:
        return {"steps": self.n_steps, "ewma_s": self.global_ewma,
                "events": list(self.events),
                "hosts": {h: vars(s) for h, s in self.hosts.items()}}


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
