"""Transformer blocks (port of src/repro/models/transformer.py: the
dense, MoE, encoder and gated cross-attention blocks, and zamba2's
shared attention block).  ``repro`` scans a stacked block over the layer
axis; the port loops over one ``ParamTree`` per layer (``model.py``).

Cross-attention (the vlm's image keys, the encdec decoder's encoder
keys) has another key length than its queries, so it stays
``blockwise_attn``, as in ``repro``: the flash kernel takes equal
lengths only.

Every block takes ``mesh``: with it the attention (self, cross, MLA and
zamba2's shared block), the FFN, the shared experts and the cross
block's gated FFN are tensor-parallel over its "model" axis where the
parameters are this rank's blocks (``sharding.rules.tp_layout``), and the
residual stream stays whole over it between sublayers."""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import psum_bwd
from repro_torch.models.attention import _attn_out, _tp_qkv, cross_attn, \
    cross_decode_attn, cross_kv, decode_attn, gqa_decode_self_attn, \
    gqa_self_attn, gqa_spec, mla_decode_self_attn, mla_self_attn, mla_spec, \
    repeat_kv, self_attn
from repro_torch.models.ffn import ffn, ffn_spec
from repro_torch.models.layers import ACT_DTYPE, apply_rope, rmsnorm, \
    rmsnorm_spec, rope_tables
from repro_torch.models.module import P
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


def dense_block(p, cfg, run, x, positions, mesh=None):
    """With ``mesh``, the attention and the FFN are tensor-parallel over
    its "model" axis where ``p``'s blocks say so; x stays whole over it."""
    x = x.to(ACT_DTYPE)
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    x = x + gqa_self_attn(p["attn"], cfg, h, positions=positions,
                          chunk_q=run.attn_chunk_q,
                          chunk_kv=run.attn_chunk_kv, mesh=mesh)
    h = rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    x = x + ffn(p["ffn"], h, cfg.act, mesh, cfg.d_ff)
    return x


def dense_block_bidir(p, cfg, run, x, positions, mesh=None):
    """Encoder block: bidirectional self-attention (seamless-m4t's
    encoder), on flash's full (non-causal) route where it applies;
    ``mesh`` as ``dense_block``'s."""
    x = x.to(ACT_DTYPE)
    x = x + gqa_self_attn(p["attn"], cfg, rmsnorm(p["attn_norm"], x,
                                                  cfg.norm_eps),
                          positions=positions, chunk_q=run.attn_chunk_q,
                          chunk_kv=run.attn_chunk_kv, causal=False,
                          mesh=mesh)
    x = x + ffn(p["ffn"], rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg.act,
                mesh, cfg.d_ff)
    return x


def dense_block_decode(p, cfg, x, kc, vc, pos, mesh=None):
    a, kc, vc = gqa_decode_self_attn(
        p["attn"], cfg, rmsnorm(p["attn_norm"], x, cfg.norm_eps), kc, vc,
        pos, mesh)
    x = x + a
    x = x + ffn(p["ffn"], rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg.act,
                mesh, cfg.d_ff)
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


def moe_block(p, cfg, run, x, positions, mesh=None):
    """Returns (x, aux) with aux = {"lb_loss", "dropped"} of the layer
    (``mesh``: ``moe_ffn``'s, and the attention's, GQA or MLA,
    tensor-parallel where ``p``'s blocks say so)."""
    x = x.to(ACT_DTYPE)
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    if cfg.mla:
        a = mla_self_attn(p["attn"], cfg, h, positions=positions,
                          chunk_q=run.attn_chunk_q,
                          chunk_kv=run.attn_chunk_kv, mesh=mesh)
    else:
        a = gqa_self_attn(p["attn"], cfg, h, positions=positions,
                          chunk_q=run.attn_chunk_q,
                          chunk_kv=run.attn_chunk_kv, mesh=mesh)
    x = x + a
    y, aux = moe_ffn(p["moe"], cfg, rmsnorm(p["ffn_norm"], x, cfg.norm_eps),
                     mesh)
    return x + y, aux


def moe_block_decode(p, cfg, x, cache_slices, pos, mesh=None):
    """``cache_slices``: {"ckv", "kr"} (MLA) or {"k", "v"}, one layer's,
    written in place.  Returns (x, cache_slices)."""
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    if cfg.mla:
        a, _, _ = mla_decode_self_attn(p["attn"], cfg, h, cache_slices["ckv"],
                                       cache_slices["kr"], pos, mesh)
    else:
        a, _, _ = gqa_decode_self_attn(p["attn"], cfg, h, cache_slices["k"],
                                       cache_slices["v"], pos, mesh)
    x = x + a
    y, _ = moe_ffn(p["moe"], cfg, rmsnorm(p["ffn_norm"], x, cfg.norm_eps),
                   mesh)
    return x + y, cache_slices


# ============================================================== cross block
def cross_block_spec(cfg):
    """Both gates start at zero, as in ``repro``: at init ``tanh(gate)``
    is 0 and nothing of the image path reaches the output."""
    return {
        "norm": rmsnorm_spec(cfg.d_model),
        "attn": gqa_spec(cfg, kv_d_in=cfg.d_vision),
        "gate": P((1,), (None,), init="zeros"),
        "ffn_norm": rmsnorm_spec(cfg.d_model),
        "ffn": ffn_spec(cfg.d_model, cfg.d_ff, cfg.act),
        "ffn_gate": P((1,), (None,), init="zeros"),
    }


def _gated(p, cfg, x, o, mesh=None):
    """The residual adds of a cross block: the attention output ``o``
    (summed over "model" where it is tensor-parallel) and the FFN, each
    times ``tanh`` of its f32 gate cast to x's dtype."""
    x = x + torch.tanh(p["gate"]).to(x.dtype) * o
    return x + torch.tanh(p["ffn_gate"]).to(x.dtype) * ffn(
        p["ffn"], rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg.act, mesh,
        cfg.d_ff)


def cross_block(p, cfg, run, x, img_kv, mesh=None):
    """Gated cross-attention (llama-3.2-vision style) over the image
    keys and values ``img_kv`` ([B, T, KH, hd] each, ``cross_img_kv``'s);
    ``mesh`` as ``dense_block``'s."""
    x = x.to(ACT_DTYPE)
    k, v = img_kv
    o = cross_attn(p["attn"], cfg, rmsnorm(p["norm"], x, cfg.norm_eps), k, v,
                   chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv,
                   mesh=mesh)
    return _gated(p, cfg, x, o, mesh)


def cross_img_kv(p, cfg, img, mesh=None):
    """Cross-attention K / V [B, T, KH, hd] from the vision embeddings
    [B, T, dv] (with ``mesh``, this rank's kv heads where they split:
    ``attention.cross_kv``)."""
    return cross_kv(p["attn"], cfg, img, mesh)


def cross_block_decode(p, cfg, x, img_k, img_v, mesh=None):
    """One token's cross block against the image caches [B, T, KH, hd]
    (read only; see ``model.VLMModel``; with ``mesh``, this rank's kv
    heads where they split)."""
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    return _gated(p, cfg, x, cross_decode_attn(p["attn"], cfg, h, img_k,
                                               img_v, mesh), mesh)


# ======================================================== ssm hybrid blocks
def shared_attn_spec(cfg):
    """zamba2's shared attention + ffn block (one set of params for every
    invocation; each invocation's LoRA on q is a ``shared_lora_spec``)."""
    return {
        "norm": rmsnorm_spec(cfg.d_model),
        "attn": gqa_spec(cfg),
        "ffn_norm": rmsnorm_spec(cfg.d_model),
        "ffn": ffn_spec(cfg.d_model, cfg.d_ff, cfg.act),
    }


def shared_lora_spec(cfg):
    r = cfg.shared_lora_rank
    d = cfg.d_model
    return {
        "a_q": P((d, r), ("embed", None), init="fanin", fan_in=d),
        "b_q": P((r, cfg.n_heads * cfg.hd), (None, "heads"), init="zeros"),
    }


def _shared_qkv(shared, lora, cfg, h, positions, mesh=None):
    """q (with the invocation's LoRA term), k, v of the normed input h
    [B, S, D], RoPE'd at ``positions`` [S]: the two LoRA products each
    rounded to h's dtype, added to q before RoPE, as ``repro`` does.
    With ``mesh``, this rank's heads where the blocks say so (q, k, v as
    ``attention._tp_qkv`` gives them; ``h @ a_q`` whole on every rank,
    entering ``b_q``'s column block through ``psum_bwd``).  Returns (q,
    k, v, the kv-head slice its q heads read or None, whether
    tensor-parallel)."""
    b, s, _ = h.shape
    (q, k, v), kv, tp = _tp_qkv(shared["attn"], cfg, h, None, mesh)
    mid = h @ lora["a_q"].to(h.dtype)
    if tp:
        mid = psum_bwd(mid, mesh, "model")
    q_extra = mid @ lora["b_q"].to(h.dtype)
    q = q + q_extra.reshape(b, s, -1, cfg.hd)
    sin, cos = rope_tables(positions, cfg.hd, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v, kv, tp


def _shared_out(shared, cfg, x, o, tp=False, mesh=None):
    """The residual adds of the shared block: ``wo`` of the attention
    output o [B, S, H, hd] (its row block summed over "model" where
    ``tp``), then the FFN (tensor-parallel where its blocks say so)."""
    x = x + _attn_out(shared["attn"], o, tp, mesh)
    return x + ffn(shared["ffn"], rmsnorm(shared["ffn_norm"], x,
                                          cfg.norm_eps), cfg.act, mesh,
                   cfg.d_ff)


def _shared_attn(shared, lora, cfg, run, x, positions, mesh=None):
    """The shared block over x [B, S, D]: causal self-attention on the
    flash kernel (``self_attn``; trainable under autograd), where
    ``repro`` calls ``blockwise_attn``; with ``mesh``, on this rank's
    heads."""
    x = x.to(ACT_DTYPE)
    h = rmsnorm(shared["norm"], x, cfg.norm_eps)
    q, k, v, kv, tp = _shared_qkv(shared, lora, cfg, h, positions, mesh)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    n = q.shape[2]
    o = self_attn(q, repeat_kv(k, n), repeat_kv(v, n), causal=True,
                  window=None, chunk_q=run.attn_chunk_q,
                  chunk_kv=run.attn_chunk_kv)
    return _shared_out(shared, cfg, x, o, tp, mesh)


def _shared_attn_decode(shared, lora, cfg, x, kc, vc, pos, mesh=None):
    """One token's shared block against its invocation's caches [B, T,
    KH, hd] (this rank's kv heads where they split), written in place at
    slot min(pos, T - 1).  Returns (x, kc, vc)."""
    h = rmsnorm(shared["norm"], x, cfg.norm_eps)
    q, k, v, kv, tp = _shared_qkv(shared, lora, cfg, h, pos[None], mesh)
    if k.shape[2] != kc.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads into a cache of "
                         f"{kc.shape[2]}")
    idx = torch.clamp(pos, max=kc.shape[1] - 1).reshape(1).long()
    kc.index_copy_(1, idx, k.to(kc.dtype))
    vc.index_copy_(1, idx, v.to(vc.dtype))
    kk, vv = (kc, vc) if kv is None else (kc[:, :, kv], vc[:, :, kv])
    o = decode_attn(q, kk, vv, pos + 1)
    return _shared_out(shared, cfg, x, o, tp, mesh), kc, vc
