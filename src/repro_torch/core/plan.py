"""GeoPlan: the explainable auto-planner behind ``strategy="auto"`` (port
of src/repro/core/plan.py; DESIGN.md §11).

``plan_for`` reads the same signals as the JAX package — device kind
("cuda" takes the place of "tpu"), batch-size hint, index capabilities,
the covering's measured boundary fraction, a recorded autotune — and
returns a ``GeoPlan`` whose reasons say why.

The CUDA rule for ``fused`` is the port's own, measured on an H100:
exact ``fast`` with an edge pool at hand and no ``fused`` in the config
takes the one-pass cascade kernel (``fused="onepass"``,
``ONEPASS_CUDA_REASON``).  Every other plan, and every plan for the CPU,
keeps the JAX package's off-TPU rule (the gathered path unless the
config asks for a fused one).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

# Planner thresholds (the JAX package's, unchanged; DESIGN.md §11).
HYBRID_BOUNDARY_FRAC = 0.35
SMALL_BATCH = 1024
SHARD_MIN_POINTS = 1 << 17

# The measurement behind the CUDA rule (PERF.md §5, traced with
# scripts/fast_paths_trace.py): device ms a 2^24-point batch of exact
# ``fast`` on an H100, one state (3,944 blocks, covering level 9) / the
# national map (220,864 blocks, level 12).
ONEPASS_CUDA_REASON = (
    "device 'cuda': exact fast takes the one-pass cascade kernel "
    "(kernels/cascade.py), measured on an H100 at 5.48 / 11.07 device ms "
    "a 2^24-point batch against the gathered path's 26.17 / 31.77 (one "
    "state at covering level 9 / the national map at level 12)")


@dataclasses.dataclass(frozen=True)
class GeoPlan:
    """One chosen execution plan, with its inputs and reasons."""

    strategy: str
    mode: str = "exact"
    fused: Union[bool, str] = False   # False | True | "onepass"
    sharded: bool = False
    n_shards: int = 1
    device_kind: str = "cpu"
    n_points: Optional[int] = None
    boundary_fraction: Optional[float] = None
    auto: bool = True
    reasons: Tuple[str, ...] = ()
    # fused came from the CUDA rule, not the config (``as_dict`` leaves
    # it out: the reasons say so).
    device_rule: bool = False

    def as_dict(self) -> dict:
        """JSON-ready rendering (``GeoEngine.explain``)."""
        return {
            "strategy": self.strategy, "mode": self.mode,
            "fused": self.fused, "sharded": self.sharded,
            "n_shards": self.n_shards, "device_kind": self.device_kind,
            "n_points": (None if self.n_points is None
                         else int(self.n_points)),
            "boundary_fraction": (None if self.boundary_fraction is None
                                  else float(self.boundary_fraction)),
            "auto": self.auto, "reasons": list(self.reasons),
        }

    def apply(self, cfg):
        """Fold the plan into an EngineConfig (replaces mode + fused)."""
        return dataclasses.replace(cfg, mode=self.mode, fused=self.fused)


def device_kind_of(device=None) -> str:
    """"cuda" or "cpu": the kind of ``device``, or of the default device
    (the card when there is one)."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def covering_boundary_fraction(covering) -> float:
    """Area share of the covering owned by boundary cells — under
    uniform on-map traffic, the expected candidate-PIP fraction."""
    lo = np.asarray(covering.lo, np.int64)
    hi = np.asarray(covering.hi, np.int64)
    val = np.asarray(covering.val)
    span = hi - lo + 1
    total = int(span.sum())
    if total == 0:
        return 0.0
    return float(span[val < 0].sum() / total)


def explicit_plan(strategy: str, cfg, device_kind: str = None) -> GeoPlan:
    """The plan recording a caller-pinned strategy."""
    return GeoPlan(strategy=strategy, mode=cfg.mode,
                   fused=("onepass" if strategy == "fast_onepass"
                          else cfg.fused),
                   device_kind=device_kind or device_kind_of(),
                   auto=False, reasons=("explicit strategy request",))


def plan_for(cfg, *, covering=None, capabilities: Optional[dict] = None,
             n_points: Optional[int] = None,
             device_kind: Optional[str] = None,
             n_devices: Optional[int] = None,
             tuning: Optional[dict] = None) -> GeoPlan:
    """Choose an execution plan (see module docstring).

    ``capabilities=None`` plans a fresh build; a dict
    (``GeoIndexSet.capabilities()``) constrains the plan to what an
    existing artifact can execute.
    """
    device_kind = device_kind or device_kind_of()
    if n_devices is None:
        n_devices = max(torch.cuda.device_count(), 1) \
            if device_kind == "cuda" else 1
    fresh = capabilities is None
    caps = capabilities or {}
    reasons = []

    bf = None
    if covering is not None:
        bf = covering_boundary_fraction(covering)

    has_cell_index = fresh or covering is not None or caps.get("fast")
    can_cascade = fresh or caps.get("simple") or caps.get("census")
    fast_pool_ok = (fresh or caps.get("fast_pool", False)
                    or caps.get("census", False))
    tune = dict(tuning or {})
    # A recorded autotune win only transfers within its device kind.
    tuned_onepass = (tune.get("winner") == "fast_onepass"
                     and tune.get("device_kind", device_kind)
                     == device_kind)

    # -- strategy -----------------------------------------------------------
    if not has_cell_index:
        strategy = "simple"
        reasons.append("no covering or fast index available: only the "
                       "cascade can run")
    elif (n_points is not None and n_points < SMALL_BATCH
          and covering is None and not caps.get("fast")):
        strategy = "simple"
        reasons.append(f"batch hint {n_points} < {SMALL_BATCH}: the "
                       f"covering BFS would dominate a one-shot batch")
    elif tuned_onepass and cfg.mode == "exact" and fast_pool_ok:
        strategy = "fast_onepass"
        reasons.append(
            f"recorded autotune on {device_kind!r} measured fast_onepass "
            f"fastest (be={tune.get('be')}, "
            f"{tune.get('pts_per_sec', 0):.3g} pts/s): measurement "
            f"overrides threshold heuristics")
    elif bf is not None and bf >= HYBRID_BOUNDARY_FRAC and can_cascade:
        strategy = "hybrid"
        reasons.append(f"measured boundary fraction {bf:.3f} >= "
                       f"{HYBRID_BOUNDARY_FRAC}: cascade PIP beats flat "
                       f"candidate lists on heavy boundary traffic")
    else:
        strategy = "fast"
        if bf is not None:
            reasons.append(f"measured boundary fraction {bf:.3f} < "
                           f"{HYBRID_BOUNDARY_FRAC}: true hits dominate")
        else:
            reasons.append("no covering to measure boundary traffic yet; "
                           "cell index is the paper's default winner")

    # -- mode ---------------------------------------------------------------
    mode = cfg.mode
    if mode == "approx":
        reasons.append("approx mode kept from config (error bounded by "
                       "the leaf cell diagonal)")

    # -- fused kernel -------------------------------------------------------
    runs_candidate_pip = (strategy in ("simple", "hybrid")
                          or (strategy in ("fast", "fast_onepass")
                              and mode == "exact"))
    pool_cap = {"simple": "simple_pool", "hybrid": "simple_pool",
                "fast": "fast_pool",
                "fast_onepass": "fast_pool"}[strategy]
    # A pool is usable when built or buildable (an artifact that carries
    # its census packs pools on demand).
    pool_available = (fresh or caps.get(pool_cap, False)
                      or caps.get("census", False))
    onepass_ok = (strategy in ("fast", "fast_onepass")
                  and mode == "exact" and pool_available)
    device_rule = False
    if strategy == "fast_onepass":
        fused = "onepass"
        reasons.append("fast_onepass pins the one-pass fused cascade "
                       "kernel (kernels/cascade.py)")
    elif cfg.fused == "onepass":
        if onepass_ok:
            fused = "onepass"
            reasons.append("one-pass fused cascade requested by config")
        else:
            fused = bool(runs_candidate_pip and pool_available)
            reasons.append(
                "onepass requested but it needs the exact fast path with "
                "an edge pool: "
                + ("kept the two-kernel fused path" if fused
                   else "dropped (no candidate PIP or no edge pool)"))
    elif cfg.fused:
        fused = runs_candidate_pip and pool_available
        reasons.append("fused requested by config"
                       if fused else
                       "fused requested but unusable here (no candidate "
                       "PIP or no edge pool built): dropped")
    elif device_kind == "cuda" and onepass_ok:
        fused = "onepass"
        device_rule = True
        reasons.append(ONEPASS_CUDA_REASON)
    else:
        fused = False
        if runs_candidate_pip:
            reasons.append(f"device {device_kind!r}: the gathered path "
                           f"stays the default until a measured rule "
                           f"says otherwise")

    # -- sharding recommendation --------------------------------------------
    sharded = False
    n_shards = 1
    if (n_devices > 1 and n_points is not None
            and n_points >= SHARD_MIN_POINTS and has_cell_index):
        sharded = True
        n_shards = n_devices
        reasons.append(f"{n_devices} devices and batch hint {n_points} >= "
                       f"{SHARD_MIN_POINTS}: route via assign_sharded")

    return GeoPlan(strategy=strategy, mode=mode, fused=fused,
                   sharded=sharded, n_shards=n_shards,
                   device_kind=device_kind, n_points=n_points,
                   boundary_fraction=bf, auto=True,
                   reasons=tuple(reasons), device_rule=device_rule)
