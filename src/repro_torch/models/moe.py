"""Mixture-of-Experts (port of src/repro/models/moe.py).

``moe_ffn`` routes each token to its top-k experts (router in f32),
capacity-buckets the (token, choice) pairs (``distributed.dispatch``),
runs every expert's SwiGLU on its bucket, and sums each token's weighted
rows back; shared experts, when the config has them, run through
``ffn`` on every token (tensor-parallel over "model" where their width
is this rank's block, ``sharding.rules.tp_layout``).  ``aux`` carries
the Switch-style load-balance loss ``E * sum(me * ce)`` and the number
of dropped (token, choice) pairs (i32).  Capacity is ``ceil(T * k / E *
capacity_factor)`` for the T tokens of the call, as in ``repro``: a
decode step (T = B) can drop pairs that a forward over the same
positions keeps.

Top-k is a stable descending sort cut at k: the order of
``jax.lax.top_k`` (values descending, the lower index first on a tie),
which ``torch.topk`` does not promise.

With a mesh that has a "model" axis, ``moe_ffn`` is ``repro``'s
``shard_map`` body on this rank (``_moe_mesh``): the activations are
this rank's rows (split on ``mesh.batch_axes``) and the same on every
rank of the model axis, the experts are split over "model", and each
rank routes its rows to its own experts, so one ``psum`` over "model"
of the bf16 partial outputs combines them.  As in ``repro``:

  * capacity is counted per data shard (``b_loc`` rows), so drops differ
    from the one-rank path's;
  * the expert weights arrive cast to bf16 and split over "data" (FSDP)
    and are all-gathered over it here;
  * when the model axis is a multiple of E, each expert's hidden
    dimension is cut into tp = n_model / E virtual experts (SwiGLU
    factorizes over it; the down projection's halves are partial sums
    that the psum adds), and each drop is counted tp times, so
    ``dropped // tp``;
  * ``me`` / ``ce`` are averaged over the batch axes and ``dropped``
    summed over every axis; a batch the data extent does not divide is
    replicated.

Gradients follow JAX's transposes under ``shard_map``: the tokens and
the top-k weights that enter this rank's experts are the same on every
model rank and feed rank-specific work, so their gradient is summed
over "model" (``psum_bwd``); the output psum passes its gradient on as
it is (``psum_fwd``), and so do ``me`` / ``ce``'s means over the data
axes; the expert weights' gather over "data" reduce-scatters their
gradient where the batch is split on "data" and slices it where it is
replicated.  Virtual experts come from weights every model rank holds
whole, so their slice's gradient is summed over "model" too.

Under the sequence-parallel residual (``sp``: the input is this rank's
sequence block) the input is all-gathered whole along the sequence, as
``repro``'s ``shard_map`` in_specs take it (the gradient: this rank's
block, every rank's being whole after the body's sums), the body runs
as above, and each rank keeps its sequence block of the output (the
backward all-gathers it: every rank's partial output reads the whole).
The shared experts take the sequence-parallel ``ffn``.

With a mesh that has no "model" axis, ``repro`` runs the one-rank path
over the whole batch (capacity from all B rows, routing across the data
shards), which GSPMD partitions across the data shards.  The port
(``_moe_slots``) keeps every decision of that path global and splits
only the expert work over the n ranks of the batch axes: each rank
gathers the rows, routes the whole batch and builds the one capacity
plan of C slots an expert (the routes, drops, ``me`` / ``ce`` and
load-balance loss are one process's on every rank; ``dropped`` is
counted once), then runs the experts on its own slice of every
expert's slots, ``[i c, (i + 1) c)`` with ``c = ceil(C / n)`` (slots
past C are empty rows): ``E c`` rows, 1 / n of the expert FLOPs
whatever the routing.  The slices are all-gathered along the slot
dimension (the backward reduce-scatters the slot gradients, each rank's
a share) and each rank combines its own tokens' rows in slot order, so
each output row is one process's; the combine reads only those rows,
so nothing of the gathered output is saved for the backward.  The
load-balance loss, which every rank computes whole, passes 1 / n of its
gradient on each rank.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.dispatch import gather_from_buckets, \
    items_in, plan_routes, scatter_to_buckets, slot_slice, slot_tables
from repro_torch.launch.mesh import block_fwd, gather_fwd, psum_bwd, \
    psum_fwd
from repro_torch.models.ffn import ffn, ffn_spec, silu
from repro_torch.models.layers import dense_spec, seq_whole
from repro_torch.models.module import P
from repro_torch.sharding.rules import mesh_extent


def moe_spec(cfg):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    spec = {
        "router": dense_spec(d, e, ("embed", None)),
        "w_gate": P((e, d, f), ("expert", "embed", "moe_mlp"),
                    init="fanin", fan_in=d),
        "w_up": P((e, d, f), ("expert", "embed", "moe_mlp"),
                  init="fanin", fan_in=d),
        "w_down": P((e, f, d), ("expert", "moe_mlp", "embed"),
                    init="fanin", fan_in=f),
    }
    if cfg.n_shared_experts:
        spec["shared"] = ffn_spec(d, cfg.d_ff_expert * cfg.n_shared_experts,
                                  "swiglu")
    return spec


def _router(params, cfg, x2d):
    """x2d [T, D] -> (probs [T, k] f32, ids [T, k] i32, (me, ce))."""
    logits = x2d.float() @ params["router"]["w"].float()
    probs_all = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs_all, dim=-1, descending=True,
                              stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance terms.
    me = probs_all.mean(dim=0)                                 # [E]
    # Counts of each expert's picks, summed as f32 ones: exact below 2^24,
    # so bit-equal to a ``bincount``, which the meta device lacks.
    ids = top_i.reshape(-1)
    ce = torch.zeros(cfg.n_experts, dtype=torch.float32,
                     device=ids.device).index_add_(
        0, ids, torch.ones(ids.shape, dtype=torch.float32,
                           device=ids.device)) / (x2d.shape[0] * cfg.top_k)
    return top_p, top_i.to(torch.int32), (me, ce)


def _expert_ffn(w_gate, w_up, w_down, buf):
    """buf [E, C, D] -> [E, C, D] through per-expert SwiGLU."""
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    return torch.bmm(silu(g) * u, w_down.to(buf.dtype))


def _moe_local(params, cfg, x2d, e_lo: int, e_loc: int, capacity: int,
               enter=None):
    """Route the tokens to the ``e_loc`` experts from ``e_lo``; return the
    partial output (zero rows for tokens whose experts live elsewhere),
    the aux terms and the dropped-pair count.  ``enter`` wraps the
    tokens and the top-k weights where they enter these experts (the
    mesh path's ``psum_bwd`` over "model")."""
    t, d = x2d.shape
    k = cfg.top_k
    top_p, top_i, (me, ce) = _router(params, cfg, x2d)
    if enter is not None:
        x2d, top_p = enter(x2d), enter(top_p)
    flat_e = top_i.reshape(-1)
    local = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    bucket = torch.where(local, flat_e - e_lo, e_loc).to(torch.int32)
    item_of = torch.arange(t * k, dtype=torch.int32, device=x2d.device) // k
    plan = plan_routes(bucket, e_loc, capacity)
    tabs = slot_tables(plan, e_loc, capacity, item_of=item_of,
                       weights=top_p.reshape(-1))
    buf = scatter_to_buckets(plan, x2d, e_loc, capacity,
                             item_for_slot=tabs[0])
    h = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                    buf.reshape(e_loc, capacity, d))
    out = gather_from_buckets(tabs, h.reshape(e_loc * capacity, d), t,
                              per_item=k)
    return out, me, ce, plan.n_dropped


def capacity_of(cfg, tokens: int) -> int:
    """Slots per expert for a call over ``tokens`` tokens."""
    return max(1, int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def _grad_share(v: torch.Tensor, n: int) -> torch.Tensor:
    """``v``'s value, bit for bit, with 1 / ``n`` of its gradient."""
    return v if n == 1 else v.detach() + (v - v.detach()) / n


def _dp_axes(mesh, b_loc: int) -> tuple:
    """``repro``'s data axes for a batch whose rows this rank holds
    ``b_loc`` of: ("pod", "data") on the mesh, or () when the global
    batch does not divide over them (``moe.py:116-119``).  The port's
    rows are split on ``mesh.batch_axes``; the two must agree."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    split = tuple(mesh.batch_axes)
    b = b_loc * mesh_extent(mesh, split)
    if b % mesh_extent(mesh, dp):
        dp = ()
    if set(a for a in dp if mesh.shape[a] > 1) != \
            set(a for a in split if mesh.shape[a] > 1):
        raise NotImplementedError(
            f"moe_ffn: the rows are split on {split}, repro's MoE layer "
            f"splits a batch of {b} on {dp}")
    return dp


def _gathered_experts(wg, wu, wd, mesh, d: int, reduce: bool) -> dict:
    """The expert weights in bf16 (cast first, as ``repro`` does),
    all-gathered over "data" where the step handed them split (FSDP);
    ``reduce``: the batch is split on "data", so each rank's gradient is
    a share (``gather_fwd``)."""
    def one(w, dim):
        w = w.to(torch.bfloat16)
        if w.shape[dim] == d:
            return w
        return gather_fwd(w, mesh, "data", dim, reduce=reduce)
    return {"w_gate": one(wg, 1), "w_up": one(wu, 1), "w_down": one(wd, 2)}


def _moe_mesh(params, cfg, x, mesh):
    """``repro``'s shard_map body on this rank (see the module doc)."""
    b, s, d = x.shape
    e = cfg.n_experts
    n_model = mesh.shape["model"]
    dp = _dp_axes(mesh, b)
    rank = mesh.coords["model"]

    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if e % n_model == 0:
        tp, e_loc = 1, e // n_model
        if wg.shape[0] != e_loc:
            raise ValueError(f"moe_ffn: {wg.shape[0]} experts on this rank, "
                             f"the rules place {e_loc}")
    elif n_model % e == 0:
        # Virtual experts: each expert's hidden dim in tp slices, so
        # E * tp == n_model; this rank holds virtual expert ``rank``.
        tp, e_loc = n_model // e, 1
        f = cfg.d_ff_expert
        assert f % tp == 0, (f, tp)
        wg, wu, wd = (psum_bwd(w, mesh, "model") for w in (wg, wu, wd))
        dl = wg.shape[1]
        wg = wg.reshape(e, dl, tp, f // tp).transpose(1, 2) \
            .reshape(e * tp, dl, f // tp)[rank:rank + 1]
        wu = wu.reshape(e, dl, tp, f // tp).transpose(1, 2) \
            .reshape(e * tp, dl, f // tp)[rank:rank + 1]
        wd = wd.reshape(e, tp, f // tp, wd.shape[2]) \
            .reshape(e * tp, f // tp, wd.shape[2])[rank:rank + 1]
    else:
        raise ValueError(f"n_experts={e} vs model axis {n_model}: "
                         "need one to divide the other")
    lp = {"router": params["router"],
          **_gathered_experts(wg, wu, wd, mesh, d, "data" in dp)}
    capacity = capacity_of(cfg, b * s)
    out, me, ce, dropped = _moe_local(
        lp, cfg, x.reshape(b * s, d), (rank // tp) * e_loc, e_loc, capacity,
        enter=lambda t: psum_bwd(t, mesh, "model"))
    if tp > 1:
        dropped = dropped // tp             # each drop counted tp times
    # Combine in bf16: halves the per-layer [T_loc, D] all-reduce.
    y = psum_fwd(out.to(torch.bfloat16), mesh, "model")
    if dp:
        n = mesh_extent(mesh, dp)
        me = psum_fwd(me, mesh, dp) / n
        ce = mesh.psum(ce, dp) / n
    dropped = mesh.psum(dropped, "model")
    if dp:
        dropped = mesh.psum(dropped, dp)
    return y.reshape(b, s, d), e * torch.sum(me * ce), dropped


def _moe_slots(params, cfg, x, mesh):
    """A mesh without "model": ``repro``'s one-rank path over the whole
    batch, its expert slots split over the batch axes (see the module
    doc)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    axes = tuple(mesh.batch_axes)
    n, i = mesh_extent(mesh, axes), mesh.index(axes)
    xg = gather_fwd(x, mesh, axes, 0, reduce=True).reshape(-1, d)
    t = xg.shape[0]
    capacity = capacity_of(cfg, t)
    top_p, top_i, (me, ce) = _router(params, cfg, xg)
    item_of = torch.arange(t * k, dtype=torch.int32, device=x.device) // k
    plan = plan_routes(top_i.reshape(-1), e, capacity)
    tabs = slot_tables(plan, e, capacity, item_of=item_of,
                       weights=top_p.reshape(-1))
    mine = slot_slice(tabs[0], e, capacity, n, i)
    w = _gathered_experts(params["w_gate"], params["w_up"],
                          params["w_down"], mesh, d, "data" in axes)
    buf = scatter_to_buckets(plan, xg, e, mine.shape[0] // e,
                             item_for_slot=mine)
    h = _expert_ffn(w["w_gate"], w["w_up"], w["w_down"],
                    buf.reshape(e, -1, d))
    h = gather_fwd(h, mesh, axes, 1, reduce=True)[:, :capacity]
    y = gather_from_buckets(items_in(tabs, i * b * s, b * s),
                            h.reshape(e * capacity, d), b * s, per_item=k)
    lb = _grad_share(e * torch.sum(me * ce), n)
    return y.reshape(b, s, d), lb, plan.n_dropped


def moe_ffn(params, cfg, x, mesh=None, sp=False):
    """x [B, S, D] -> ([B, S, D], aux dict).  With a mesh, ``x`` is this
    rank's rows (see the module doc) and ``aux`` holds the whole batch's
    load-balance loss and dropped count; with ``sp``, x and the output
    are this rank's sequence blocks [B, S / m, D]."""
    b, s, d = x.shape
    e = cfg.n_experts
    if sp:
        y, lb, dropped = _moe_mesh(params, cfg, seq_whole(x, mesh, sp),
                                   mesh)
        y = block_fwd(y, mesh, "model", 1)
    elif mesh is not None and "model" in mesh.axis_names:
        y, lb, dropped = _moe_mesh(params, cfg, x, mesh)
    elif mesh is not None and mesh.size > 1:
        y, lb, dropped = _moe_slots(params, cfg, x, mesh)
    else:
        out, me, ce, dropped = _moe_local(params, cfg, x.reshape(b * s, d),
                                          0, e, capacity_of(cfg, b * s))
        y, lb = out.reshape(b, s, d), e * torch.sum(me * ce)
    aux = {"lb_loss": lb, "dropped": dropped}
    if cfg.n_shared_experts:
        y = y + ffn(params["shared"], x, "swiglu", mesh,
                    cfg.d_ff_expert * cfg.n_shared_experts, sp)
    return y, aux
