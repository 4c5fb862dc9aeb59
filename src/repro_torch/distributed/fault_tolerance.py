"""Fault tolerance: step watchdog, straggler detection, elastic remesh plan.

On a real multi-host deployment every host runs the same SPMD program; a
failed or slow host manifests as (a) a missed heartbeat or (b) a step time
far above the fleet median.  This module implements the control-plane logic
host-locally (it is pure bookkeeping -- the data plane is the
``torch.distributed`` collectives):

  * ``StepWatchdog``   -- rolling step-time stats; flags stragglers
    (step > straggler_factor x median) and hangs (> hang_timeout).
  * ``HeartbeatFile``  -- per-host liveness via mtime on a shared FS (the
    usual pattern on a cluster without an external coordinator).
  * ``ElasticPlan``    -- given the surviving host set, picks the largest
    feasible (data, model) mesh <= the old one and returns the remesh recipe:
    checkpoint -> re-init runtime with survivors -> restore with new
    shardings (``repro_torch.checkpoint.checkpoint.restore(shardings=)``).

A launcher wires these together: on straggler detection it logs and
optionally checkpoints; on hang it exits nonzero so the cluster manager
restarts the job, which resumes from LATEST.  ``launch.serve`` sizes its
mesh with :func:`plan_remesh` (the fleet is the world size).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path


@dataclass
class WatchdogConfig:
    window: int = 50
    straggler_factor: float = 2.0
    hang_timeout_s: float = 600.0
    min_samples: int = 5


class StepWatchdog:
    def __init__(self, cfg: WatchdogConfig = WatchdogConfig()):
        self.cfg = cfg
        self.times: deque[float] = deque(maxlen=cfg.window)
        self._last_start: float | None = None
        self.straggler_events: list[dict] = []

    def start_step(self):
        self._last_start = time.monotonic()

    def end_step(self, step: int) -> dict | None:
        """Returns a straggler event dict if this step was anomalous."""
        assert self._last_start is not None
        dt = time.monotonic() - self._last_start
        event = None
        if len(self.times) >= self.cfg.min_samples:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.cfg.straggler_factor * med:
                event = {"step": step, "step_time_s": dt, "median_s": med,
                         "factor": dt / med}
                self.straggler_events.append(event)
        self.times.append(dt)
        return event

    def hang_check(self) -> bool:
        if self._last_start is None:
            return False
        return (time.monotonic() - self._last_start) > self.cfg.hang_timeout_s

    def median(self) -> float | None:
        if not self.times:
            return None
        return sorted(self.times)[len(self.times) // 2]


class HeartbeatFile:
    """Liveness via mtime on a shared filesystem; one file per host."""

    def __init__(self, root: str | os.PathLike, host_id: int):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.path = self.root / f"host_{host_id:05d}.hb"
        self.host_id = host_id

    def beat(self, step: int):
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"step": step, "t": time.time()}))
        os.replace(tmp, self.path)

    def dead_hosts(self, timeout_s: float = 120.0) -> list[int]:
        now = time.time()
        dead = []
        for p in self.root.glob("host_*.hb"):
            if now - p.stat().st_mtime > timeout_s:
                dead.append(int(p.stem.split("_")[1]))
        return sorted(dead)


@dataclass(frozen=True)
class ElasticPlan:
    """Remesh recipe after losing hosts."""

    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    new_global_batch: int
    action: str  # "continue" | "remesh" | "abort"


def plan_remesh(old_shape: tuple[int, int], devices_left: int,
                global_batch: int, *, devices_per_host: int = 4) -> ElasticPlan:
    """Largest (data, model) mesh that fits the surviving devices.

    Keeps the model axis (TP degree is dictated by model memory), shrinks the
    data axis to the largest divisor of the old data degree that fits, and
    scales the batch proportionally (keeping per-replica batch constant, the
    standard elastic-DP policy).
    """
    data, model = old_shape
    if devices_left >= data * model:
        return ElasticPlan(old_shape, old_shape, global_batch, "continue")
    # largest ACTUAL divisor of the data degree that fits -- repeated halving
    # only visits data/2^k, which for a non-power-of-two degree can land on a
    # non-divisor (data=5 -> 2), breaking the per-replica batch split the
    # proportional rescale below relies on
    new_data = max((d for d in range(1, data + 1)
                    if data % d == 0 and d * model <= devices_left),
                   default=0)
    if new_data == 0:
        return ElasticPlan(old_shape, old_shape, global_batch, "abort")
    scale = new_data / data
    return ElasticPlan(
        old_shape, (new_data, model),
        max(1, int(global_batch * scale)), "remesh")
