"""Transformer blocks (port of the dense block of
src/repro/models/transformer.py; the other families come with their
slices).  ``repro`` scans a stacked block over the layer axis; the port
loops over one ``ParamTree`` per layer (``model.py``)."""
from __future__ import annotations

import torch

from repro_torch.models.attention import gqa_decode_self_attn, \
    gqa_self_attn, gqa_spec
from repro_torch.models.ffn import ffn, ffn_spec
from repro_torch.models.layers import ACT_DTYPE, rmsnorm, rmsnorm_spec

CACHE_DTYPE = torch.bfloat16


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
