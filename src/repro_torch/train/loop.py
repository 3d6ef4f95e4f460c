"""Fault-tolerant training loop (the port of ``repro.train.loop``).

* **checkpoint/restart**: restore-latest on entry; periodic async save of
  (params, opt_state); manifests are atomic, so a crash at any point
  resumes from the last published step.
* **elastic restarts**: with ``param_shardings`` / ``opt_shardings`` the
  restored state is placed on the current mesh, which may differ from
  the mesh that saved it.
* **deterministic replay**: the data stream is a pure function of (seed,
  step), so after a restart it continues bit-identically.
* **straggler detection**: each step's wall time is held against the
  rolling median of the last 20; a step above ``straggler_factor`` times
  it calls ``on_straggler`` (the hook where a deployment would re-queue
  a slow host's shard).
* **failure injection**: ``fail_at_step`` raises mid-run, once the save
  in flight is published (tests use it to show restart equivalence).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None   # failure injection (tests)


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: List[float]
    step_times: List[float]
    stragglers: List[int]
    restored_from: Optional[int]


def _device(state) -> torch.device:
    """The device of the train state's first parameter."""
    model = state[0] if isinstance(state, tuple) else state
    if not isinstance(model, nn.Module):
        raise TypeError(f"the train state must be a model or (model, ef), "
                        f"not {type(state).__name__}")
    return next(model.parameters()).device


def fit(train_step: Callable, params: Any, opt_state: Any, data,
        ckpt: Optional[CheckpointManager], cfg: LoopConfig,
        *, on_straggler: Optional[Callable[[int, float], None]] = None,
        param_shardings: Any = None, opt_shardings: Any = None
        ) -> LoopResult:
    """Run the loop; ``data.batch_at(step)`` supplies numpy batches, moved
    to the parameters' device.  ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` (``models.model.make_train_step``).
    ``param_shardings`` / ``opt_shardings`` (a ``DeviceMesh`` each): the
    restored state is placed on them by the sharding rules (the elastic
    restart; ``CheckpointManager.restore(shardings=)``)."""
    device = _device(params)
    start = 0
    restored = None
    if ckpt is not None and ckpt.latest_step() is not None:
        shard = None
        if param_shardings is not None:
            shard = {"params": param_shardings, "opt": opt_shardings}
        state, meta = ckpt.restore({"params": params, "opt": opt_state},
                                   shardings=shard)
        params, opt_state = state["params"], state["opt"]
        start = int(meta["step"]) + 1
        restored = start - 1

    losses: List[float] = []
    times: List[float] = []
    stragglers: List[int] = []
    for step in range(start, cfg.total_steps):
        if cfg.fail_at_step is not None and step == cfg.fail_at_step:
            if ckpt is not None:
                # the failure lands after the outstanding save is published,
                # so where a restart resumes does not depend on the writer
                # thread's speed
                ckpt.wait()
            raise RuntimeError(f"injected failure at step {step}")
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        if len(times) >= 5:
            med = float(np.median(times[-20:]))
            if dt > cfg.straggler_factor * med:
                stragglers.append(step)
                if on_straggler:
                    on_straggler(step, dt)
        if ckpt is not None and (step + 1) % cfg.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state},
                      meta={"step": step, "loss": loss})
    if ckpt is not None:
        ckpt.save(cfg.total_steps - 1,
                  {"params": params, "opt": opt_state},
                  meta={"step": cfg.total_steps - 1,
                        "loss": losses[-1] if losses else float("nan")})
        ckpt.wait()
    return LoopResult(cfg.total_steps - 1, losses, times, stragglers,
                      restored)
