"""Distributed trainer: checkpoint/restart, straggler detection, metrics
(mirrors repro/runtime/trainer.py).

Fault tolerance model (designed for 1000+ nodes, exercised in tests on 1):
  * atomic async checkpoints every ``ckpt_every`` steps (CheckpointManager);
  * crash at any point -> restart resumes from the last complete checkpoint
    with a bitwise-identical trajectory (data cursor is part of the state);
    on the card that holds when every op of the step is deterministic
    (``torch.use_deterministic_algorithms(True)``, with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts);
  * ``SimulatedFailure`` hook injects crashes in tests;
  * straggler detection: per-step wall times -> EWMA z-score; flagged steps
    are logged (at fleet scale the controller would re-shard around the slow
    host — here surfaced via metrics, consumed by runtime/elastic.py).

The parameters are the model (an ``nn.Module``) on ``device`` (None: the
card), or placed on a mesh of cards by the caller, which the step updates
in place; ``opt_state`` is AdamW's state of
its trainable leaves. Host batches reach the device through
``device.to_device``, and the metrics are read once a step with
``float()``, as the reference reads them, so the host clock of a step
covers its device work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device, to_device
from repro_torch.models.api import ModelAPI, make_train_step, trainable
from repro_torch.optim import AdamWConfig, adamw_init


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_z: float = 3.0
    straggler_min_steps: int = 8


class StragglerMonitor:
    """EWMA + z-score step-time anomaly detector (per host stream)."""

    def __init__(self, alpha: float = 0.1, z: float = 3.0, min_steps: int = 8):
        self.alpha = alpha
        self.z = z
        self.min_steps = min_steps
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n == 1:
            self.mean = dt
            return False
        is_straggler = False
        std = max(self.var, 1e-12) ** 0.5
        if self.n > self.min_steps and dt > self.mean + self.z * std and dt > 1.5 * self.mean:
            is_straggler = True
            self.flagged.append((step, dt))
        # update EWMA only with non-outlier samples so one hiccup doesn't
        # poison the baseline
        if not is_straggler:
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


class Trainer:
    def __init__(
        self,
        api: ModelAPI,
        opt_cfg: AdamWConfig,
        tcfg: TrainerConfig,
        *,
        compute_specs: Optional[dict] = None,
        donate: bool = True,
        device=None,
    ):
        """``compute_specs``: the model's compute layout across a mesh
        (``make_train_step``); the trainer then trains the module the caller
        placed on the mesh (``launch.mesh.place_params``, e.g. at
        ``core.pooling.pooled_specs``) and set as ``params``, with
        ``opt_state = adamw_init(trainable(params))`` beside it. ``save``
        writes full arrays in the reference's layout (one rank writes, the
        others wait), and ``try_restore`` puts each rank's slices back in
        the same placement. ``donate`` changes nothing: the step already
        updates in place."""
        self.device = resolve_device(device)
        self.api = api
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.train_step = make_train_step(api, opt_cfg, compute_specs=compute_specs)
        self.monitor = StragglerMonitor(z=tcfg.straggler_z, min_steps=tcfg.straggler_min_steps)
        self.metrics_log: list[dict] = []
        self.step = 0
        self.params: Any = None
        self.opt_state: Any = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        self.params = self.api.init(seed, device=self.device)
        self.opt_state = adamw_init(trainable(self.params))
        self.step = 0

    def try_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        if self.params is None:
            self.init_state()
        (self.params, self.opt_state), extras = self.ckpt.restore(
            (self.params, self.opt_state)
        )
        self.step = int(extras["step"])
        return True

    def save(self, sync: bool = False):
        extras = {"step": self.step}
        if sync:
            self.ckpt.save(self.step, (self.params, self.opt_state), extras)
        else:
            self.ckpt.save_async(self.step, (self.params, self.opt_state), extras)

    # ------------------------------------------------------------------
    def run(
        self,
        batches: Iterator,
        n_steps: int,
        *,
        fail_at: Optional[int] = None,
        on_step: Optional[Callable[[int, dict], None]] = None,
    ) -> list[dict]:
        """Train for n_steps from the iterator of (step, host_batch) pairs.

        ``fail_at``: raise SimulatedFailure after completing that step count
        (tests crash-recovery). Returns the metrics log.
        """
        assert self.params is not None, "call init_state() or try_restore() first"
        done = 0
        for data_step, batch in batches:
            if done >= n_steps:
                break
            batch = {k: to_device(v, torch.from_numpy(np.asarray(v)).dtype, self.device)
                     for k, v in batch.items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch
            )
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.step += 1
            done += 1
            straggler = self.monitor.observe(self.step, dt)
            metrics.update(step=self.step, dt=dt, straggler=straggler)
            self.metrics_log.append(metrics)
            if on_step:
                on_step(self.step, metrics)
            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
            if fail_at is not None and done >= fail_at:
                raise SimulatedFailure(f"injected failure after step {self.step}")
        self.ckpt.wait()
        return self.metrics_log
