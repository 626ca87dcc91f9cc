"""Transformer blocks (port of the dense and MoE blocks of
src/repro/models/transformer.py; the other families come with their
slices).  ``repro`` scans a stacked block over the layer axis; the port
loops over one ``ParamTree`` per layer (``model.py``)."""
from __future__ import annotations

import torch

from repro_torch.models.attention import gqa_decode_self_attn, \
    gqa_self_attn, gqa_spec, mla_decode_self_attn, mla_self_attn, mla_spec
from repro_torch.models.ffn import ffn, ffn_spec
from repro_torch.models.layers import ACT_DTYPE, rmsnorm, rmsnorm_spec
from repro_torch.models.moe import moe_ffn, moe_spec

CACHE_DTYPE = torch.bfloat16


# ============================================================== dense block
def dense_block_spec(cfg):
    return {
        "attn_norm": rmsnorm_spec(cfg.d_model),
        "attn": gqa_spec(cfg),
        "ffn_norm": rmsnorm_spec(cfg.d_model),
        "ffn": ffn_spec(cfg.d_model, cfg.d_ff, cfg.act),
    }


def dense_block(p, cfg, run, x, positions):
    x = x.to(ACT_DTYPE)
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    x = x + gqa_self_attn(p["attn"], cfg, h, positions=positions,
                          chunk_q=run.attn_chunk_q,
                          chunk_kv=run.attn_chunk_kv)
    h = rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    x = x + ffn(p["ffn"], h, cfg.act)
    return x


def dense_block_decode(p, cfg, x, kc, vc, pos):
    a, kc, vc = gqa_decode_self_attn(
        p["attn"], cfg, rmsnorm(p["attn_norm"], x, cfg.norm_eps), kc, vc,
        pos)
    x = x + a
    x = x + ffn(p["ffn"], rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg.act)
    return x, kc, vc


# ================================================================ moe block
def moe_block_spec(cfg):
    attn = mla_spec(cfg) if cfg.mla else gqa_spec(cfg)
    return {
        "attn_norm": rmsnorm_spec(cfg.d_model),
        "attn": attn,
        "ffn_norm": rmsnorm_spec(cfg.d_model),
        "moe": moe_spec(cfg),
    }


def moe_block(p, cfg, run, x, positions):
    """Returns (x, aux) with aux = {"lb_loss", "dropped"} of the layer."""
    x = x.to(ACT_DTYPE)
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    attn = mla_self_attn if cfg.mla else gqa_self_attn
    x = x + attn(p["attn"], cfg, h, positions=positions,
                 chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv)
    y, aux = moe_ffn(p["moe"], cfg, rmsnorm(p["ffn_norm"], x, cfg.norm_eps))
    return x + y, aux


def moe_block_decode(p, cfg, x, cache_slices, pos):
    """``cache_slices``: {"ckv", "kr"} (MLA) or {"k", "v"}, one layer's,
    written in place.  Returns (x, cache_slices)."""
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    if cfg.mla:
        a, _, _ = mla_decode_self_attn(p["attn"], cfg, h, cache_slices["ckv"],
                                       cache_slices["kr"], pos)
    else:
        a, _, _ = gqa_decode_self_attn(p["attn"], cfg, h, cache_slices["k"],
                                       cache_slices["v"], pos)
    x = x + a
    y, _ = moe_ffn(p["moe"], cfg, rmsnorm(p["ffn_norm"], x, cfg.norm_eps))
    return x + y, cache_slices
