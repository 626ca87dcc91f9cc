"""Fault-tolerant training driver (port of src/repro/runtime/driver.py).

Designed for fleets where steps fail (preemption, flaky hosts, data blips):

  * checkpoint/restart — async checkpoints every ``ckpt_every`` steps; any
    step exception restores the latest checkpoint into the live tensors
    and resumes.  The data pipeline is stateless (batch = f(seed, step))
    so the resume is bitwise.
  * bounded retries  — ``max_restarts`` guards against crash loops.
  * straggler watch  — per-step wall times are tracked; a step slower than
    ``straggler_factor`` x the running median is counted and surfaced via
    ``on_straggler`` (on a real fleet this triggers hot-spares / re-slicing;
    the hook keeps the policy pluggable).
  * failure injection — ``fail_at`` raises inside given steps (once each),
    which is how the restart path is tested.

``train_step(params, opt, batch) -> (params, opt, metrics)`` is
``runtime.steps.make_train_step``'s; the step's wall time ends where the
host reads the loss (``float``), which waits for the device, where
``repro`` blocks on it.

Under a mesh, ``params`` / ``opt`` are this rank's blocks and
``shardings`` is the tree of ``NamedSharding`` shaped like
``{"params": params, "opt": opt}`` (``adamw.state_shardings`` for the
optimizer's part): every rank runs the loop in step (the same batches,
the same injected failures), checkpoints are saved whole by rank 0 and
each rank restores its own blocks, as ``repro``'s restore re-places
arrays onto the live params' shardings.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    max_restarts: int = 5
    straggler_factor: float = 3.0
    log_every: int = 10


class InjectedFailure(RuntimeError):
    pass


def train_loop(train_step, params, opt, source, dcfg: DriverConfig,
               shardings=None, fail_at: Optional[set] = None,
               on_straggler: Optional[Callable[[int, float], None]] = None,
               log: Callable[[str], None] = print):
    """Run to dcfg.total_steps with checkpoint/restart. Returns
    (params, opt, history dict)."""
    mgr = CheckpointManager(dcfg.ckpt_dir, keep=dcfg.keep)
    fail_at = set(fail_at or ())
    fired: set = set()
    restarts = 0
    step_times: list[float] = []
    hist = {"loss": [], "restarts": 0, "stragglers": 0, "steps_run": 0}

    start = mgr.latest_step()
    step = 0
    if start is not None:
        mgr.restore(start, {"params": params, "opt": opt}, shardings)
        step = start
        log(f"[driver] resumed from checkpoint step {start}")
    else:
        # Initial checkpoint: a failure before the first periodic save must
        # restart from the true initial state, not silently re-train on
        # already-stepped params.
        mgr.save(0, {"params": params, "opt": opt}, shardings=shardings)
        mgr.wait()

    while step < dcfg.total_steps:
        try:
            batch = source.batch_at(step)
            t0 = time.perf_counter()
            if step in fail_at and step not in fired:
                fired.add(step)
                raise InjectedFailure(f"injected failure at step {step}")
            params, opt, metrics = train_step(params, opt, batch)
            loss = float(metrics["loss"])       # waits for the device
            dt = time.perf_counter() - t0
            hist["steps_run"] += 1

            # Straggler detection on the running median.
            if len(step_times) >= 5:
                med = float(np.median(step_times[-50:]))
                if dt > dcfg.straggler_factor * med:
                    hist["stragglers"] += 1
                    if on_straggler:
                        on_straggler(step, dt / med)
                    log(f"[driver] straggler: step {step} took {dt:.2f}s "
                        f"({dt/med:.1f}x median)")
            step_times.append(dt)

            hist["loss"].append(loss)
            if step % dcfg.log_every == 0:
                log(f"[driver] step {step}: loss={loss:.4f} "
                    f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            step += 1
            if step % dcfg.ckpt_every == 0 or step == dcfg.total_steps:
                mgr.save(step, {"params": params, "opt": opt},
                         shardings=shardings)
        except Exception as e:  # noqa: BLE001 — the whole point
            restarts += 1
            hist["restarts"] = restarts
            log(f"[driver] step {step} failed ({e!r}); "
                f"restart {restarts}/{dcfg.max_restarts}")
            if restarts > dcfg.max_restarts:
                raise
            # Every rank sees the same committed steps (a write in flight
            # on rank 0 is waited for).
            mgr.wait()
            latest = mgr.latest_step()
            if latest is not None:
                mgr.restore(latest, {"params": params, "opt": opt},
                            shardings)
                step = latest
                log(f"[driver] restored step {latest}")
            else:
                step = 0
    mgr.wait()
    return params, opt, hist
