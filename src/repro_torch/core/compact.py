"""O(N) stable compaction (cumsum + scatter) — port of
src/repro/core/compact.py.

``compact_indices(mask, cap)`` returns (idx [cap], valid [cap]): the first
``cap`` indices where mask is True, in order, plus a validity mask for the
unfilled slots.  No step reads a count back to the host, so a compaction
on the card never synchronizes.

``capacity_for`` is the one place static buffer capacities are sized.
"""
from __future__ import annotations

import torch


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def capacity_for(n: int, frac: float, *, floor: int = 256,
                 quantum: int = 256, ceiling: int | None = None) -> int:
    """Static compaction capacity for a batch of ``n``: ``n * frac``,
    raised to ``floor``, rounded up to a ``quantum`` multiple, and
    clamped to ``ceiling`` (default ``n``)."""
    cap = round_up(max(int(n * frac), floor), quantum)
    return min(cap, n if ceiling is None else ceiling)


def scatter_filled(prior: torch.Tensor, idx: torch.Tensor,
                   slot_ok: torch.Tensor, values: torch.Tensor):
    """Write ``values`` back through compacted slots, dropping unfilled
    ones.

    Unfilled slots from ``compact_indices`` all alias row 0, so an
    unmasked duplicate-index write would let a stale value race the real
    row-0 update.  Unfilled slots are rerouted to a scratch row past the
    end, which is cut off, so every surviving write is unique.  This is
    the ONLY sanctioned write-back for compacted buffers.
    """
    n = prior.shape[0]
    out = torch.cat([prior, prior.new_zeros(1)])
    out[torch.where(slot_ok, idx, n).long()] = values.to(prior.dtype)
    return out[:n]


def compact_indices(mask: torch.Tensor, cap: int):
    n = mask.shape[0]
    pos = torch.cumsum(mask.int(), 0) - 1         # slot among True entries
    dest = torch.where(mask, pos, cap).clamp(max=cap)   # False -> scratch
    idx = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    idx[dest] = torch.arange(n, dtype=torch.int32, device=mask.device)
    total = mask.sum()
    valid = torch.arange(cap, device=mask.device) < total
    return idx[:cap], valid
