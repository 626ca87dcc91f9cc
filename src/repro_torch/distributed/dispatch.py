"""Capacity-bucketed dispatch (port of src/repro/distributed/dispatch.py,
the single-rank primitives that ``models.moe`` runs without a mesh).

Given per-item integer bucket ids, produce a static-shape routing plan:
items are stably sorted by bucket, positioned within their bucket, and
dropped beyond ``capacity`` (dropping is counted, never silent).  Bucket
ids, slots and counts are int32 throughout, as in ``repro``.

One difference in how a result is summed, not in what it is:
``gather_from_buckets`` adds an item's rows one after another in slot
order (``repro``'s scatter-add on the CPU visits the slots in that
order), through an [n_items, per_item] slot table, where ``repro``
scatter-adds.  A scatter-add on the card (``index_add_``) uses atomics,
so a sum of three or more bf16 rows would change from run to run; the
table makes a decode or train step deterministic.

Two helpers split one plan's work over n ranks (``models.moe`` on a
mesh without "model"): ``slot_slice``, a rank's slice of every bucket's
slots, and ``items_in``, the slot tables of a rank's own items.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RoutePlan(NamedTuple):
    order: torch.Tensor      # [N] permutation: items sorted by bucket
    bucket: torch.Tensor     # [N] i32 bucket id per sorted item
    slot: torch.Tensor       # [N] i32 position within bucket (sorted order)
    keep: torch.Tensor       # [N] bool — survives capacity (sorted order)
    flat_ix: torch.Tensor    # [N] i32 index into [n_buckets*capacity]
                             #     (overflow -> n_buckets*capacity sentinel)
    n_dropped: torch.Tensor  # [] i32


def plan_routes(bucket_ids: torch.Tensor, n_buckets: int,
                capacity: int) -> RoutePlan:
    """bucket_ids: [N] int in [0, n_buckets]; id == n_buckets means "not
    mine / inactive" and is never kept."""
    n = bucket_ids.shape[0]
    bucket_ids = bucket_ids.to(torch.int32)
    order = torch.argsort(bucket_ids, stable=True)
    sb = bucket_ids[order]
    pos = (torch.arange(n, dtype=torch.int32, device=sb.device)
           - torch.searchsorted(sb, sb, side="left", out_int32=True))
    active = sb < n_buckets
    keep = active & (pos < capacity)
    flat = torch.where(keep, sb * capacity + pos, n_buckets * capacity)
    n_dropped = (active & ~keep).sum(dtype=torch.int32)
    return RoutePlan(order=order, bucket=sb, slot=pos, keep=keep,
                     flat_ix=flat.to(torch.int32), n_dropped=n_dropped)


def slot_tables(plan: RoutePlan, n_buckets: int, capacity: int,
                item_of: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None):
    """Inverse routing tables, indexed by *buffer slot* (not route entry).

    Only int32 indices are scattered (never [N, D] payloads), so the
    dispatch's memory stays bounded by the capacity buffer.

    Returns (item_for_slot [n_buckets*capacity] i32 with -1 = empty,
             weight_for_slot [n_buckets*capacity] f32).
    """
    n_slots = n_buckets * capacity
    dev = plan.order.device
    src_items = plan.order if item_of is None else item_of[plan.order]
    src_items = torch.where(plan.keep, src_items.to(torch.int32), -1)
    # Every dropped entry lands on the sentinel slot n_slots, which is cut
    # off; kept entries have distinct slots.
    ix = plan.flat_ix.long()
    ifs = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    ifs = ifs.index_put((ix,), src_items)
    if weights is None:
        wfs = (ifs[:-1] >= 0).to(torch.float32)
    else:
        w = torch.where(plan.keep, weights[plan.order].float(), 0.0)
        wfs = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev)
        wfs = wfs.index_put((ix,), w)[:-1]
    return ifs[:-1], wfs


def scatter_to_buckets(plan: RoutePlan, payload: torch.Tensor,
                       n_buckets: int, capacity: int,
                       item_of: Optional[torch.Tensor] = None,
                       item_for_slot: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """payload: [n_items, D] in original item order.  Fills the capacity
    buffer by *gathering* payload rows per slot (see slot_tables).

    Returns [n_buckets * capacity, D]; empty/dropped rows are zero.
    """
    if item_for_slot is None:
        item_for_slot, _ = slot_tables(plan, n_buckets, capacity, item_of)
    rows = payload[torch.clamp(item_for_slot, 0,
                               payload.shape[0] - 1).long()]
    return rows * (item_for_slot >= 0)[:, None].to(payload.dtype)


def slot_slice(item_for_slot: torch.Tensor, n_buckets: int, capacity: int,
               n: int, i: int) -> torch.Tensor:
    """Part ``i`` of ``n`` of a slot table (``item_for_slot``
    [n_buckets * capacity]): slots ``[i c, (i + 1) c)`` of every
    bucket's, ``c = ceil(capacity / n)``, those past ``capacity`` empty
    (-1); [n_buckets * c] i32.  The parts of all ``i`` together cover
    every slot once."""
    c = -(-capacity // n)
    tab = torch.nn.functional.pad(item_for_slot.reshape(n_buckets, capacity),
                                  (0, n * c - capacity), value=-1)
    return tab[:, i * c:(i + 1) * c].reshape(n_buckets * c)


def items_in(slot_tabs, lo: int, n_items: int):
    """The slot tables (``slot_tables``) of items ``[lo, lo + n_items)``
    alone, renumbered from 0, every other slot empty."""
    ifs, wfs = slot_tabs
    mine = (ifs >= lo) & (ifs < lo + n_items)
    return torch.where(mine, ifs - lo, -1), wfs


def _item_slot_table(item_for_slot: torch.Tensor, n_items: int,
                    per_item: int) -> torch.Tensor:
    """[n_items, per_item] i64: each item's buffer slots in slot order,
    padded with the sentinel ``n_slots`` (an item holds at most
    ``per_item`` slots: top-k routing holds k)."""
    n_slots = item_for_slot.shape[0]
    dev = item_for_slot.device
    owner = torch.where(item_for_slot >= 0, item_for_slot, n_items)
    by_item = torch.argsort(owner, stable=True)
    so = owner[by_item]
    rank = (torch.arange(n_slots, dtype=torch.int32, device=dev)
            - torch.searchsorted(so, so, side="left", out_int32=True))
    table = torch.full((n_items + 1, per_item), n_slots, dtype=torch.int64,
                       device=dev)
    # Empty slots (owner n_items) land in the cut-off last row, clamped
    # to its columns.
    table[so.long(), torch.clamp(rank, max=per_item - 1).long()] = by_item
    return table[:-1]


def gather_from_buckets(slot_tabs, buf: torch.Tensor, n_items: int,
                        per_item: Optional[int] = None) -> torch.Tensor:
    """Combine buffer rows back per original item (duplicates summed,
    e.g. top-k routing).  buf: [n_buckets*capacity, D];
    slot_tabs: (item_for_slot, weight_for_slot) from slot_tables().

    Each row is weighted in ``buf``'s dtype and an item's rows are added
    in slot order, one rounding per add (see the module doc).  Only the
    rows the items hold are read, so the tables of some items alone
    (``items_in``) combine those at their cost.
    ``per_item`` bounds the rows an item holds; without it the bound is
    read from the table (a wait for the device)."""
    ifs, wfs = slot_tabs
    if per_item is None:
        valid = ifs[ifs >= 0]
        per_item = max(int(torch.bincount(valid.long()).max())
                       if valid.numel() else 1, 1)
    table = _item_slot_table(ifs, n_items, per_item)
    n_slots = buf.shape[0]
    w = wfs.to(buf.dtype)[:, None]
    out = None
    for j in range(per_item):
        # Only the rows an item holds are read and weighted; the
        # sentinel slot reads a zero row.
        ix = table[:, j]
        held = (ix < n_slots)[:, None]
        ix = torch.clamp(ix, max=n_slots - 1)
        row = torch.where(held, buf[ix] * w[ix], 0.0)
        out = row if out is None else out + row
    return out
