"""Attention: GQA / MQA / MHA with RoPE and sliding windows, and
DeepSeek-V2's multi-head latent attention (port of
src/repro/models/attention.py).

Training / prefill attention in ``repro`` is ``blockwise_attn``: online
softmax over KV chunks, so the [S, S] score matrix is never
materialized.  Decode is single-token attention against a KV cache:
full, rolling-window, or MLA's compressed latent (with the absorbed
``W_uk`` / ``W_uv`` products in f32).

The one place where the port's call graph differs from ``repro``'s:
``self_attn`` sends self-attention (S == T, dv == d, no query offset) to
the port of the Pallas flash kernel, where ``repro`` calls
``blockwise_attn``, when the shape lets the kernel compute the same
function.  The route is by shape, decided before any launch:

* flash when there is no sliding window, or S <= window (then the window
  excludes no key: qpos - kpos <= S - 1 < window), and the head dim is
  at most the kernels' 128;
* ``blockwise_attn`` when S > window (the window masks keys), and when
  the head dim exceeds 128 (DeepSeek-V2's dense layer, head dim 192;
  ``flash_attn_bhsd`` itself raises there).

Flash is ``ops.flash_attn`` when no gradient is wanted and
``make_flash_attn_trainable`` (the kernel forward, a backward that
recomputes through ``blockwise_attn``) when grad is enabled and an input
requires grad.  On a CUDA tensor the forward launches the kernel
(``kernels/csrc/flash_attn_wgmma.cu`` or ``flash_attn.cu``); on the CPU
it runs the kernel's plain twin.  The two agree to rounding: the flash
kernel sums the f32 probabilities into ``l`` where ``blockwise_attn``
sums them after rounding to bf16.  MLA's prefill keeps
``blockwise_attn``, as ``repro`` (dv != d).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attn as flash_kernels
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense, dense_spec, \
    rmsnorm, rmsnorm_spec, rope_tables

NEG_INF = -1.0e30


# --------------------------------------------------------------------------
# Blockwise attention (train / prefill)
# --------------------------------------------------------------------------
def blockwise_attn(q, k, v, *, causal: bool, window: Optional[int] = None,
                   chunk_q: int = 1024, chunk_kv: int = 1024,
                   q_offset: int = 0):
    """Online-softmax attention over KV chunks.

    q: [B, S, H, D]; k, v: [B, T, KH, D] with H % KH == 0.
    Returns [B, S, H, D] in q.dtype.  Scores / stats are f32.
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]            # may differ from d (MLA)
    g = h // kh
    cq = min(chunk_q, s)
    ck = min(chunk_kv, t)
    nq = -(-s // cq)
    nk = -(-t // ck)
    # Pad sequence dims to chunk multiples (masked out below).
    if nq * cq != s:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * cq - s))
    if nk * ck != t:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * ck - t))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * ck - t))

    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qb = q.reshape(b, nq, cq, kh, g, d).float()
    kb = k.reshape(b, nk, ck, kh, d)
    vb = v.reshape(b, nk, ck, kh, dv)
    qpos = q_offset + torch.arange(nq * cq, device=dev).reshape(nq, cq)

    m = torch.full((b, nq, cq, kh, g), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, nq, cq, kh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nq, cq, kh, g, dv), dtype=torch.float32,
                      device=dev)
    for j in range(nk):
        kc, vc = kb[:, j], vb[:, j]
        sc = torch.einsum("bnckgd,bjkd->bnckgj", qb, kc.float()) * scale
        kpos = j * ck + torch.arange(ck, device=dev)          # [ck]
        ok = kpos[None, None, :] < t
        if causal:
            ok = ok & (kpos[None, None, :] <= qpos[:, :, None])
        if window is not None:
            ok = ok & (kpos[None, None, :] > qpos[:, :, None] - window)
        # ok: [nq, cq, ck] -> broadcast to [b, nq, cq, kh, g, ck]
        sc = torch.where(ok[None, :, :, None, None, :], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # Probabilities in bf16 (repro's flash-attention practice); the
        # row sum l accumulates them in f32.
        p = torch.exp(sc - m_new[..., None]).to(vc.dtype)
        r = torch.exp(m - m_new)
        l = l * r + p.sum(dim=-1, dtype=torch.float32)
        acc = acc * r[..., None] + torch.einsum(
            "bnckgj,bjkd->bnckgd", p.float(), vc.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(b, nq * cq, h, dv)[:, :s]
    return out.to(q.dtype)


def flash_takes(s: int, d: int, window: Optional[int]) -> bool:
    """Whether ``self_attn`` routes a [B, s, H, d] self-attention with
    ``window`` to the flash kernel (see the module doc)."""
    return (window is None or s <= window) and \
        d <= flash_kernels.HEAD_DIMS[-1]


def self_attn(q, k, v, *, causal: bool, window: Optional[int],
              chunk_q: int, chunk_kv: int):
    """Self-attention of q [B, S, H, D] over k, v [B, S, KH, D]: the flash
    kernel where ``flash_takes`` (trainable under autograd, else
    ``ops.flash_attn``), else ``blockwise_attn`` (see the module doc)."""
    if flash_takes(q.shape[1], q.shape[-1], window):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return flash_kernels.make_flash_attn_trainable(
                causal=causal)(q, k, v)
        return ops.flash_attn(q, k, v, causal=causal)
    return blockwise_attn(q, k, v, causal=causal, window=window,
                          chunk_q=chunk_q, chunk_kv=chunk_kv)


def decode_attn(q, k_cache, v_cache, valid_len, *,
                window: Optional[int] = None, cache_pos=None):
    """Single-token attention against a cache.

    q: [B, 1, H, D]; caches [B, T, KH, D]; valid_len [] or [B] — number of
    valid cache entries.  For rolling SWA caches pass ``cache_pos`` [B, T]
    giving each slot's absolute position (-1 = empty).
    """
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, g, d)
    sc = torch.einsum("bkgd,btkd->bkgt", qg.float(),
                      k_cache.float()) * scale
    if cache_pos is not None:
        ok = cache_pos[:, None, None, :] >= 0
    else:
        slot = torch.arange(t, device=q.device)
        vl = torch.as_tensor(valid_len, device=q.device)
        vl = vl[:, None, None, None] if vl.dim() else vl
        ok = slot[None, None, None, :] < vl
    sc = torch.where(ok, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, dv).to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------
def gqa_spec(cfg, d_in=None, kv_d_in=None):
    d = d_in or cfg.d_model
    kv_d = kv_d_in or d
    hd = cfg.hd
    return {
        "wq": dense_spec(d, cfg.n_heads * hd, ("embed", "heads"),
                         bias=cfg.qkv_bias),
        "wk": dense_spec(kv_d, cfg.n_kv_heads * hd, ("embed", "heads"),
                         bias=cfg.qkv_bias),
        "wv": dense_spec(kv_d, cfg.n_kv_heads * hd, ("embed", "heads"),
                         bias=cfg.qkv_bias),
        "wo": dense_spec(cfg.n_heads * hd, cfg.d_model, ("heads", "embed")),
    }


def gqa_project_qkv(params, cfg, x, kv_x=None, rope=None):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,T,KH,hd] (rope applied if given)."""
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    t = kv_x.shape[1]
    hd = cfg.hd
    q = dense(params["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = dense(params["wk"], kv_x).reshape(b, t, cfg.n_kv_heads, hd)
    v = dense(params["wv"], kv_x).reshape(b, t, cfg.n_kv_heads, hd)
    if rope is not None:
        sin, cos = rope
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def repeat_kv(k, n_heads):
    """Expand KV heads to n_heads (train / prefill only — the decode cache
    keeps grouped KV heads)."""
    b, t, kh, d = k.shape
    g = n_heads // kh
    if g == 1:
        return k
    return k[:, :, :, None, :].expand(b, t, kh, g, d).reshape(b, t, kh * g,
                                                               d)


def gqa_self_attn(params, cfg, x, *, positions, chunk_q, chunk_kv,
                  causal=True):
    sin, cos = rope_tables(positions, cfg.hd, cfg.rope_theta)
    q, k, v = gqa_project_qkv(params, cfg, x, rope=(sin, cos))
    k = repeat_kv(k, cfg.n_heads)
    v = repeat_kv(v, cfg.n_heads)
    o = self_attn(q, k, v, causal=causal, window=cfg.sliding_window,
                  chunk_q=chunk_q, chunk_kv=chunk_kv)
    b, s = x.shape[:2]
    return dense(params["wo"], o.reshape(b, s, -1))


def gqa_decode_self_attn(params, cfg, x, k_cache, v_cache, pos):
    """x [B,1,D]; per-layer caches [B,T,KH,hd]; pos [] absolute position
    (an int32 tensor).  Returns (out [B,1,D], k_cache, v_cache): the
    caches are written in place (one slot; ``repro`` returns updated
    copies).  For SWA the cache is a rolling buffer of length == window."""
    b = x.shape[0]
    hd = cfg.hd
    sin, cos = rope_tables(pos[None], hd, cfg.rope_theta)
    q = dense(params["wq"], x).reshape(b, 1, cfg.n_heads, hd)
    k = dense(params["wk"], x).reshape(b, 1, cfg.n_kv_heads, hd)
    v = dense(params["wv"], x).reshape(b, 1, cfg.n_kv_heads, hd)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    t = k_cache.shape[1]
    slot = (pos % t) if cfg.sliding_window else torch.clamp(pos, max=t - 1)
    idx = slot.reshape(1).long()
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    if cfg.sliding_window:
        # Rolling buffer: slot i holds absolute position pos - ((slot-i) % t),
        # valid iff non-negative.
        idx = torch.arange(t, device=x.device)
        age = (slot - idx) % t
        cache_pos = torch.where(age <= torch.clamp(pos, max=t - 1),
                                pos - age, -1)
        cache_pos = cache_pos[None, :].expand(b, t)
        o = decode_attn(q, k_cache, v_cache, None, cache_pos=cache_pos)
    else:
        o = decode_attn(q, k_cache, v_cache, pos + 1)
    out = dense(params["wo"], o.reshape(b, 1, -1))
    return out, k_cache, v_cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------
def mla_spec(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    qk_d = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wdq": dense_spec(d, cfg.q_lora, ("embed", "q_lora")),
        "q_norm": rmsnorm_spec(cfg.q_lora),
        "wuq": dense_spec(cfg.q_lora, h * qk_d, ("q_lora", "heads")),
        "wdkv": dense_spec(d, cfg.kv_lora, ("embed", "kv_lora")),
        "kv_norm": rmsnorm_spec(cfg.kv_lora),
        "wuk": dense_spec(cfg.kv_lora, h * cfg.qk_nope_dim,
                          ("kv_lora", "heads")),
        "wuv": dense_spec(cfg.kv_lora, h * cfg.v_head_dim,
                          ("kv_lora", "heads")),
        "wkr": dense_spec(d, cfg.qk_rope_dim, ("embed", None)),
        "wo": dense_spec(h * cfg.v_head_dim, d, ("heads", "embed")),
    }


def _mla_qkr(params, cfg, x, positions):
    """Shared q / rope-key computation. x [B,S,D]."""
    b, s, _ = x.shape
    h = cfg.n_heads
    cq = rmsnorm(params["q_norm"], dense(params["wdq"], x), cfg.norm_eps)
    q = dense(params["wuq"], cq).reshape(
        b, s, h, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = q[..., cfg.qk_nope_dim:]
    sin, cos = rope_tables(positions, cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    kr = dense(params["wkr"], x).reshape(b, s, 1, cfg.qk_rope_dim)
    kr = apply_rope(kr, sin, cos)
    return q_nope, q_rope, kr, (sin, cos)


def mla_self_attn(params, cfg, x, *, positions, chunk_q, chunk_kv):
    """Training / prefill MLA in the expanded (naive) form, through
    ``blockwise_attn`` as in ``repro``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, kr, _ = _mla_qkr(params, cfg, x, positions)
    ckv = rmsnorm(params["kv_norm"], dense(params["wdkv"], x), cfg.norm_eps)
    k_nope = dense(params["wuk"], ckv).reshape(b, s, h, cfg.qk_nope_dim)
    v = dense(params["wuv"], ckv).reshape(b, s, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr.expand(b, s, h, cfg.qk_rope_dim)], dim=-1)
    o = blockwise_attn(q, k, v, causal=True, chunk_q=chunk_q,
                       chunk_kv=chunk_kv)
    return dense(params["wo"], o.reshape(b, s, -1))


def mla_decode_self_attn(params, cfg, x, ckv, kr, pos):
    """Decode with the compressed cache (c_kv + k_rope) and absorbed mats.

    ckv: [B,T,kv_lora]; kr: [B,T,rope_d]; pos: [] absolute position (an
    int32 tensor).  Scores = q_nope W_uk^T . ckv + q_rope . k_rope;
    out = (P . ckv) W_uv, in f32.  Returns (out [B,1,D], ckv, kr): the
    caches are written in place (one slot; ``repro`` returns updated
    copies).
    """
    b = x.shape[0]
    h = cfg.n_heads
    q_nope, q_rope, kr_new, _ = _mla_qkr(params, cfg, x, pos[None])
    ckv_new = rmsnorm(params["kv_norm"], dense(params["wdkv"], x),
                      cfg.norm_eps)
    t = ckv.shape[1]
    idx = torch.clamp(pos, max=t - 1).reshape(1).long()
    ckv.index_copy_(1, idx, ckv_new.to(ckv.dtype))
    kr.index_copy_(1, idx, kr_new[:, :, 0].to(kr.dtype))
    wuk = params["wuk"]["w"].reshape(cfg.kv_lora, h, cfg.qk_nope_dim)
    # Absorb W_uk into the query:  [B,1,H,nope] x [C,H,nope] -> [B,H,C]
    q_abs = torch.einsum("bshn,chn->bhc", q_nope.float(), wuk.float())
    sc = torch.einsum("bhc,btc->bht", q_abs, ckv.float())
    sc = sc + torch.einsum("bshr,btr->bht", q_rope.float(), kr.float())
    sc = sc / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    ok = torch.arange(t, device=x.device)[None, None, :] < (pos + 1)
    sc = torch.where(ok, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    octx = torch.einsum("bht,btc->bhc", p, ckv.float())
    wuv = params["wuv"]["w"].reshape(cfg.kv_lora, h, cfg.v_head_dim)
    o = torch.einsum("bhc,chv->bhv", octx, wuv.float())
    out = dense(params["wo"], o.reshape(b, 1, -1).to(x.dtype))
    return out, ckv, kr
