"""Mixture-of-Experts (port of src/repro/models/moe.py, its single-rank
path).

``moe_ffn`` routes each token to its top-k experts (router in f32),
capacity-buckets the (token, choice) pairs (``distributed.dispatch``),
runs every expert's SwiGLU on its bucket, and sums each token's weighted
rows back; shared experts, when the config has them, run through
``ffn`` on every token.  ``aux`` carries the Switch-style load-balance
loss ``E * sum(me * ce)`` and the number of dropped (token, choice)
pairs (i32).  Capacity is ``ceil(T * k / E * capacity_factor)`` for the
T tokens of the call, as in ``repro``: a decode step (T = B) can drop
pairs that a forward over the same positions keeps.

``repro``'s mesh path (experts over "model", weights FSDP-gathered over
"data") comes with the distributed slice: ``moe_ffn(..., mesh=...)``
raises.  Top-k is a stable descending sort cut at k: the order of
``jax.lax.top_k`` (values descending, the lower index first on a tie),
which ``torch.topk`` does not promise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.dispatch import gather_from_buckets, \
    plan_routes, scatter_to_buckets, slot_tables
from repro_torch.models.ffn import ffn, ffn_spec, silu
from repro_torch.models.layers import dense_spec
from repro_torch.models.module import P


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
    ce = torch.bincount(top_i.reshape(-1), minlength=cfg.n_experts).float() \
        / (x2d.shape[0] * cfg.top_k)
    return top_p, top_i.to(torch.int32), (me, ce)


def _expert_ffn(w_gate, w_up, w_down, buf):
    """buf [E, C, D] -> [E, C, D] through per-expert SwiGLU."""
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    return torch.bmm(silu(g) * u, w_down.to(buf.dtype))


def _moe_local(params, cfg, x2d, e_lo: int, e_loc: int, capacity: int):
    """Route the tokens to the ``e_loc`` experts from ``e_lo``; return the
    partial output (zero rows for tokens whose experts live elsewhere),
    the aux terms and the dropped-pair count."""
    t, d = x2d.shape
    k = cfg.top_k
    top_p, top_i, (me, ce) = _router(params, cfg, x2d)
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


def moe_ffn(params, cfg, x, mesh=None):
    """x [B, S, D] -> ([B, S, D], aux dict)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_ffn over a mesh (experts sharded over ranks) is not ported "
            "yet (ROADMAP §1 item 7, distributed)")
    b, s, d = x.shape
    e = cfg.n_experts
    out, me, ce, dropped = _moe_local(params, cfg, x.reshape(b * s, d), 0,
                                      e, capacity_of(cfg, b * s))
    aux = {"lb_loss": e * torch.sum(me * ce), "dropped": dropped}
    y = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + ffn(params["shared"], x, "swiglu")
    return y, aux
