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
parameters are this rank's blocks (``sharding.rules.tp_layout``).
Between sublayers the residual stream is sequence-parallel where
``repro`` pins it to [BATCH, "model", None] and ``act_spec`` splits it
(``layers.seq_parallel`` of the whole sequence's length): the dense,
encoder, MoE and cross blocks take and return this rank's sequence block
[B, S / m, D], their norms run on it (the whole scale leaves through
``layers.sp_tree``: each rank's gradient covers its tokens), and the
sublayers gather it in and reduce-scatter out (``models.attention``,
``models.ffn``, ``models.moe``).  zamba2's shared block takes the whole
stream of its Mamba2 layers, which ``repro`` does not pin, cuts its
block on entry and gathers it back whole on exit.  Decode's one token
and a sequence the axis does not divide keep the residual whole."""
from __future__ import annotations

import torch

from repro_torch.models.attention import _attn_out, _q_offset, _rows, \
    _tp_qkv, blockwise_attn, cross_attn, cross_decode_attn, \
    cross_kv, decode_attn, gqa_decode_self_attn, gqa_self_attn, gqa_spec, \
    mla_decode_self_attn, mla_self_attn, mla_spec, repeat_kv, self_attn
from repro_torch.models.ffn import ffn, ffn_spec
from repro_torch.models.layers import ACT_DTYPE, apply_rope, rmsnorm, \
    rmsnorm_spec, rope_tables, seq_block, seq_gather, seq_parallel, \
    seq_whole, sp_tree
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


def _norm(p, x, cfg, mesh=None, sp=False):
    """rmsnorm of x; on a sequence block (``sp``) the whole scale enters
    through ``sp_tree`` (each rank's gradient covers its tokens)."""
    return rmsnorm(sp_tree(p, mesh, sp), x, cfg.norm_eps)


def dense_block(p, cfg, run, x, positions, mesh=None):
    """With ``mesh``, the attention and the FFN are tensor-parallel over
    its "model" axis where ``p``'s blocks say so, and x is this rank's
    sequence block where ``seq_parallel(mesh, len(positions))`` (see the
    module doc)."""
    sp = seq_parallel(mesh, positions.shape[-1])
    x = x.to(ACT_DTYPE)
    h = _norm(p["attn_norm"], x, cfg, mesh, sp)
    x = x + gqa_self_attn(p["attn"], cfg, h, positions=positions,
                          chunk_q=run.attn_chunk_q,
                          chunk_kv=run.attn_chunk_kv, mesh=mesh, sp=sp)
    h = _norm(p["ffn_norm"], x, cfg, mesh, sp)
    x = x + ffn(p["ffn"], h, cfg.act, mesh, cfg.d_ff, sp)
    return x


def dense_block_bidir(p, cfg, run, x, positions, mesh=None):
    """Encoder block: bidirectional self-attention (seamless-m4t's
    encoder), on flash's full (non-causal) route where it applies;
    ``mesh`` as ``dense_block``'s."""
    sp = seq_parallel(mesh, positions.shape[-1])
    x = x.to(ACT_DTYPE)
    x = x + gqa_self_attn(p["attn"], cfg, _norm(p["attn_norm"], x, cfg,
                                                mesh, sp),
                          positions=positions, chunk_q=run.attn_chunk_q,
                          chunk_kv=run.attn_chunk_kv, causal=False,
                          mesh=mesh, sp=sp)
    x = x + ffn(p["ffn"], _norm(p["ffn_norm"], x, cfg, mesh, sp), cfg.act,
                mesh, cfg.d_ff, sp)
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
    tensor-parallel where ``p``'s blocks say so; x this rank's sequence
    block as ``dense_block``'s)."""
    sp = seq_parallel(mesh, positions.shape[-1])
    x = x.to(ACT_DTYPE)
    h = _norm(p["attn_norm"], x, cfg, mesh, sp)
    attn = mla_self_attn if cfg.mla else gqa_self_attn
    x = x + attn(p["attn"], cfg, h, positions=positions,
                 chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv,
                 mesh=mesh, sp=sp)
    y, aux = moe_ffn(p["moe"], cfg, _norm(p["ffn_norm"], x, cfg, mesh, sp),
                     mesh, sp)
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


def _gated(p, cfg, x, o, mesh=None, sp=False):
    """The residual adds of a cross block: the attention output ``o``
    (summed over "model" where it is tensor-parallel) and the FFN, each
    times ``tanh`` of its f32 gate cast to x's dtype (x and o this rank's
    sequence blocks with ``sp``: the gates and the norm's scale through
    ``sp_tree``)."""
    gate, ffn_gate = (sp_tree(p[k], mesh, sp) for k in ("gate", "ffn_gate"))
    x = x + torch.tanh(gate).to(x.dtype) * o
    return x + torch.tanh(ffn_gate).to(x.dtype) * ffn(
        p["ffn"], _norm(p["ffn_norm"], x, cfg, mesh, sp), cfg.act, mesh,
        cfg.d_ff, sp)


def cross_block(p, cfg, run, x, img_kv, mesh=None, sp=False):
    """Gated cross-attention (llama-3.2-vision style) over the image
    keys and values ``img_kv`` ([B, T, KH, hd] each, ``cross_img_kv``'s);
    ``mesh`` as ``dense_block``'s, and ``sp`` whether x is this rank's
    sequence block (``seq_parallel`` of the tokens' length: the model's
    call)."""
    x = x.to(ACT_DTYPE)
    k, v = img_kv
    o = cross_attn(p["attn"], cfg, _norm(p["norm"], x, cfg, mesh, sp), k, v,
                   chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv,
                   mesh=mesh, sp=sp)
    return _gated(p, cfg, x, o, mesh, sp)


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


def _shared_qkv(shared, lora, cfg, h, positions, mesh=None, sp=False):
    """q (with the invocation's LoRA term), k, v of the normed input h
    [B, S, D], RoPE'd at ``positions`` [S]: the two LoRA products each
    rounded to h's dtype, added to q before RoPE, as ``repro`` does.
    With ``mesh``, this rank's heads where the blocks say so (q, k, v as
    ``attention._tp_qkv`` gives them; ``h @ a_q`` whole on every rank,
    entering ``b_q``'s column block through ``psum_bwd``).  With ``sp``
    h is this rank's sequence block: ``h @ a_q`` is taken on its tokens
    and all-gathered where the heads split.  Returns (the attention's
    leaves, q, k, v, the kv-head slice its q heads read or None, whether
    tensor-parallel)."""
    b = h.shape[0]
    attn, (q, k, v), tp, kv = _tp_qkv(shared["attn"], cfg, h, None, mesh,
                                      sp)
    # a_q is read on the rank's tokens; b_q too where the heads do not
    # split (else it is the rank's column block).
    a_q, b_q = sp_tree(lora["a_q"], mesh, sp), sp_tree(lora["b_q"], mesh,
                                                       sp and not tp)
    mid = h @ a_q.to(h.dtype)
    if tp:
        mid = seq_gather(mid, mesh, sp)
    q_extra = mid @ b_q.to(h.dtype)
    q = q + q_extra.reshape(b, q.shape[1], -1, cfg.hd)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    own = _rows(rope, mesh) if q.shape[1] != k.shape[1] else rope
    return attn, apply_rope(q, *own), apply_rope(k, *rope), v, kv, tp


def _shared_out(shared, attn, cfg, x, o, tp=False, mesh=None, sp=False):
    """The residual adds of the shared block: ``wo`` of the attention
    output o [B, S, H, hd] (``attn``: the attention's leaves as
    ``_shared_qkv`` gives them; its row block summed over "model" where
    ``tp``, reduce-scattered along the sequence with ``sp``), then the FFN
    (tensor-parallel where its blocks say so)."""
    x = x + _attn_out(attn, o, tp, mesh, sp)
    return x + ffn(shared["ffn"], _norm(shared["ffn_norm"], x, cfg, mesh,
                                        sp), cfg.act, mesh, cfg.d_ff, sp)


def _shared_attn(shared, lora, cfg, run, x, positions, mesh=None):
    """The shared block over x [B, S, D]: causal self-attention on the
    flash kernel (``self_attn``; trainable under autograd), where
    ``repro`` calls ``blockwise_attn``; with ``mesh``, on this rank's
    heads.  x is the whole stream (``repro`` pins only the block): where
    ``seq_parallel`` holds the block runs on this rank's sequence block
    (``seq_block``) and its output is gathered whole."""
    x, sp = seq_block(x.to(ACT_DTYPE), mesh)
    h = _norm(shared["norm"], x, cfg, mesh, sp)
    attn, q, k, v, kv, tp = _shared_qkv(shared, lora, cfg, h, positions,
                                        mesh, sp)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    if q.shape[1] != k.shape[1]:
        o = blockwise_attn(q, k, v, causal=True, chunk_q=run.attn_chunk_q,
                           chunk_kv=run.attn_chunk_kv,
                           q_offset=_q_offset(q, k, mesh))
    else:
        n = q.shape[2]
        o = self_attn(q, repeat_kv(k, n), repeat_kv(v, n), causal=True,
                      window=None, chunk_q=run.attn_chunk_q,
                      chunk_kv=run.attn_chunk_kv)
    return seq_whole(_shared_out(shared, attn, cfg, x, o, tp, mesh, sp),
                     mesh, sp)


def _shared_attn_decode(shared, lora, cfg, x, kc, vc, pos, mesh=None):
    """One token's shared block against its invocation's caches [B, T,
    KH, hd] (this rank's kv heads where they split), written in place at
    slot min(pos, T - 1).  Returns (x, kc, vc)."""
    h = rmsnorm(shared["norm"], x, cfg.norm_eps)
    attn, q, k, v, kv, tp = _shared_qkv(shared, lora, cfg, h, pos[None],
                                        mesh)
    if k.shape[2] != kc.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads into a cache of "
                         f"{kc.shape[2]}")
    idx = torch.clamp(pos, max=kc.shape[1] - 1).reshape(1).long()
    kc.index_copy_(1, idx, k.to(kc.dtype))
    vc.index_copy_(1, idx, v.to(vc.dtype))
    kk, vv = (kc, vc) if kv is None else (kc[:, :, kv], vc[:, :, kv])
    o = decode_attn(q, kk, vv, pos + 1)
    return _shared_out(shared, attn, cfg, x, o, tp, mesh), kc, vc
