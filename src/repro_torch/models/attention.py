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

Under a mesh whose "model" axis splits the q heads
(``sharding.rules.tp_layout``), ``gqa_self_attn`` and
``gqa_decode_self_attn`` run on this rank's heads (Megatron's column /
row layout; ``repro`` constrains q / k / v to [BATCH, None, "model",
None]): the head counts come from the blocks' shapes, the input enters
through ``psum_bwd``, flash runs on [B_loc * H / m, S, hd], and ``wo``'s
row block gives bf16 partials that ``layers.dense_rows`` sums over
"model".  Where the kv heads are whole on every rank (``n_kv_heads`` not
a multiple of the axis), every rank computes them all, as one process
does, and reads the one its q heads use (head j reads kv head j // (H /
KH)); their gradient is summed over "model" there (``psum_bwd``).

MLA has the same layout over its heads: ``wuk`` / ``wuv`` are column
blocks, ``wo`` a row block, ``wuq`` a re-blocked leaf whose piece is the
rank's heads' columns (``sharding.rules.tp_pieces``); the latents ``cq``
(``wdq`` gathered whole: a split ``cq`` would need its norm summed over
"model" and an all-gather), ``ckv`` and the rope key ``kr`` are computed
whole on every rank and feed its heads through ``psum_bwd``; prefill
runs ``blockwise_attn`` over the rank's heads, decode absorbs ``wuk`` /
``wuv`` over them against the whole ``ckv`` / ``kr`` cache.

Cross-attention (the vlm's gated blocks over the image tokens, the
encdec decoder's over the encoder's output) has the same layout:
``cross_kv`` gives this rank's kv heads of the other input (all of them
where they are whole), ``cross_attn`` / ``cross_decode_attn`` its q
heads of the residual, ``blockwise_attn`` / ``decode_attn`` over the kv
head they read, and ``wo``'s row block summed by ``dense_rows``.

Under the sequence-parallel residual (``sp``: ``layers.seq_parallel``,
the block's call) the input is this rank's sequence block [B, S / m, D]
of the normed residual, and the output leaves as one:

* heads that split: the input is all-gathered along the sequence
  (``layers.seq_gather``) into q / k / v of the rank's heads over the
  whole sequence, the attention is unchanged (flash at [B * H / m, S,
  hd]), and ``wo``'s partials leave by a reduce-scatter along the
  sequence (``dense_rows(..., sp=True)``).  Where the kv heads are whole
  on every rank, k / v are projected on the rank's own tokens and
  all-gathered (``repro``'s "kv-gather"), ``wk`` / ``wv`` entering
  through ``layers.sp_tree`` (each rank's gradient a share);
* q heads that do not split (6 on a 4-way axis): every leaf enters
  through ``sp_tree``, the rank projects q / k / v on its own tokens,
  all-gathers k / v, attends its queries over every key with
  ``blockwise_attn(..., q_offset=)`` (its block's first position) and
  applies the whole ``wo`` to its own rows, with no collective on the
  output;
* MLA: the down projections ``wdq`` / ``wdkv``, their norms and ``wkr``
  run on the rank's tokens (through ``sp_tree``), and the latents ``cq``
  (where the heads split), ``ckv`` and the rope key ``kr`` are
  all-gathered along the sequence;
* cross-attention: the query side as above; the other input's k / v
  (``cross_kv``) are as they were.

Decode (one token) never takes ``sp``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attn as flash_kernels
from repro_torch.kernels import ops
from repro_torch.launch.mesh import psum_bwd
from repro_torch.models.layers import apply_rope, dense, dense_rows, \
    dense_spec, model_block, rmsnorm, rmsnorm_spec, rope_tables, \
    seq_gather, sp_tree

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
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,T,KH,hd] (rope applied if given;
    H and KH are the blocks' head counts)."""
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    t = kv_x.shape[1]
    hd = cfg.hd
    q = dense(params["wq"], x).reshape(b, s, -1, hd)
    k = dense(params["wk"], kv_x).reshape(b, t, -1, hd)
    v = dense(params["wv"], kv_x).reshape(b, t, -1, hd)
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


def tp_heads(params, cfg, mesh):
    """(tp, kv) of this rank's attention, from the blocks' shapes: ``tp``
    whether it holds a block of the q heads over "model"; ``kv``, where
    it holds every kv head (see the module doc), the slice of them its q
    heads read, else None."""
    hd = cfg.hd
    h = params["wq"]["w"].shape[-1] // hd
    kh = params["wk"]["w"].shape[-1] // hd
    if not model_block(mesh, h, cfg.n_heads):
        if kh != cfg.n_kv_heads:
            raise ValueError(f"kv heads {kh} of {cfg.n_kv_heads} beside "
                             f"all {h} q heads")
        return False, None
    if model_block(mesh, kh, cfg.n_kv_heads):
        return True, None
    g = cfg.n_heads // cfg.n_kv_heads
    if g % h:
        raise ValueError(f"{h} q heads a rank straddle kv heads of {g}")
    first = mesh.index("model") * h // g
    return True, slice(first, first + 1)


def sp_params(params, cfg, mesh, sp=False):
    """(params, tp, kv): ``tp_heads``' (tp, kv), and the attention's
    leaves with those a rank reads on its own tokens under ``sp``
    through ``layers.sp_tree``: every leaf where the q heads do not
    split, ``wk`` / ``wv`` where the kv heads are whole (see the module
    doc)."""
    tp, kv = tp_heads(params, cfg, mesh)
    if sp and not tp:
        params = sp_tree(params, mesh)
    elif sp and kv is not None:
        params = {k: sp_tree(params[k], mesh, k in ("wk", "wv"))
                  for k in ("wq", "wk", "wv", "wo")}
    return params, tp, kv


def _rows(rope, mesh):
    """The rope tables (sin, cos) [S, hd / 2] of this rank's sequence
    block (None stays None)."""
    if rope is None:
        return None
    n = rope[0].shape[0] // mesh.axis_size("model")
    i = mesh.index("model")
    return tuple(t[i * n:(i + 1) * n] for t in rope)


def _proj(p, x, cfg, rope=None):
    """dense(p, x) [B, S, .] as heads [B, S, ., hd], RoPE'd if given."""
    b, s = x.shape[:2]
    y = dense(p, x).reshape(b, s, -1, cfg.hd)
    return y if rope is None else apply_rope(y, *rope)


def _tp_qkv(params, cfg, x, rope, mesh, sp=False):
    """(params, (q, k, v), tp, kv): ``sp_params``' leaves, tp and kv, and
    q / k / v of this rank's heads (rope (sin, cos) over the whole
    sequence, or None).  With ``sp`` x is this rank's sequence block: q
    over the whole sequence where the heads split, over its own tokens
    where they do not; k / v over the whole sequence (projected on the
    own tokens and all-gathered where every rank computes every kv
    head)."""
    params, tp, kv = sp_params(params, cfg, mesh, sp)
    own = _rows(rope, mesh) if sp else rope
    if tp:
        xt = seq_gather(x, mesh, sp)
        q = _proj(params["wq"], xt, cfg, rope)
        if kv is None:
            return params, (q, _proj(params["wk"], xt, cfg, rope),
                            _proj(params["wv"], xt, cfg)), tp, kv
    else:
        q = _proj(params["wq"], x, cfg, own)
    # Every kv head, from the input as this rank holds it.
    k, v = _proj(params["wk"], x, cfg, own), _proj(params["wv"], x, cfg)
    if sp or tp:
        k, v = seq_gather(k, mesh, sp), seq_gather(v, mesh, sp)
    return params, (q, k, v), tp, kv


def _q_offset(q, k, mesh):
    """The position of q's first row: this rank's sequence block's where
    q holds fewer rows than k (the own-token queries of heads that do
    not split), else 0."""
    return mesh.index("model") * q.shape[1] if q.shape[1] != k.shape[1] \
        else 0


def gqa_self_attn(params, cfg, x, *, positions, chunk_q, chunk_kv,
                  causal=True, mesh=None, sp=False):
    """Self-attention of x [B, S, D] (this rank's sequence block [B, S /
    m, D] with ``sp``; ``positions`` [S] the whole sequence's); with
    ``mesh``, tensor-parallel over its "model" axis where the blocks say
    so (see the module doc)."""
    sin, cos = rope_tables(positions, cfg.hd, cfg.rope_theta)
    params, (q, k, v), tp, kv = _tp_qkv(params, cfg, x, (sin, cos), mesh, sp)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    if q.shape[1] != k.shape[1]:
        o = blockwise_attn(q, k, v, causal=causal, window=cfg.sliding_window,
                           chunk_q=chunk_q, chunk_kv=chunk_kv,
                           q_offset=_q_offset(q, k, mesh))
        return _attn_out(params, o, tp, mesh, sp)
    h = q.shape[2]
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    o = self_attn(q, k, v, causal=causal, window=cfg.sliding_window,
                  chunk_q=chunk_q, chunk_kv=chunk_kv)
    return _attn_out(params, o, tp, mesh, sp)


def _attn_out(params, o, tp, mesh, sp=False):
    """``wo`` of the attention output o [B, S, H, hd]: this rank's row
    block summed over "model" (``dense_rows``; reduce-scattered along
    the sequence with ``sp``) where ``tp``."""
    b, s = o.shape[:2]
    if tp:
        return dense_rows(params["wo"], o.reshape(b, s, -1), mesh, sp)
    return dense(params["wo"], o.reshape(b, s, -1))


def cross_kv(params, cfg, kv_x, mesh=None):
    """Cross-attention k, v [B, T, KH, hd] of the other input kv_x [B, T,
    d_in]: this rank's kv heads where they split over "model" (kv_x
    enters through ``psum_bwd``), every kv head where they are whole (as
    one process computes them; their gradient summed over "model")."""
    tp, kv = tp_heads(params, cfg, mesh)
    b, t = kv_x.shape[:2]
    src = psum_bwd(kv_x, mesh, "model") if tp and kv is None else kv_x
    k = dense(params["wk"], src).reshape(b, t, -1, cfg.hd)
    v = dense(params["wv"], src).reshape(b, t, -1, cfg.hd)
    if tp and kv is not None:
        k, v = psum_bwd(k, mesh, "model"), psum_bwd(v, mesh, "model")
    return k, v


def _cross_q(params, cfg, h, k, v, mesh, sp=False):
    """(the leaves, q of this rank's heads from h [B, S, D] (its sequence
    block with ``sp``: q over the whole sequence where the heads split,
    its own tokens where they do not), the kv heads they read of k / v
    [B, T, KH, hd], whether tensor-parallel)."""
    params, tp, kv = sp_params(params, cfg, mesh, sp)
    if sp and not tp:
        # Each rank's queries read every key: its gradient of k / v a
        # share.
        k, v = psum_bwd(k, mesh, "model"), psum_bwd(v, mesh, "model")
    q = dense(params["wq"], seq_gather(h, mesh, sp) if tp else h)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    return params, q.reshape(q.shape[0], q.shape[1], -1, cfg.hd), k, v, tp


def cross_attn(params, cfg, h, k, v, *, chunk_q, chunk_kv, mesh=None,
               sp=False):
    """Cross-attention of the normed residual h [B, S, D] (its sequence
    block with ``sp``) over k, v (``cross_kv``'s), through
    ``blockwise_attn`` (no RoPE, no mask): the key length differs from
    the query length."""
    params, q, k, v, tp = _cross_q(params, cfg, h, k, v, mesh, sp)
    o = blockwise_attn(q, k, v, causal=False, chunk_q=chunk_q,
                       chunk_kv=chunk_kv)
    return _attn_out(params, o, tp, mesh, sp)


def cross_decode_attn(params, cfg, h, k_cache, v_cache, mesh=None):
    """One token's cross-attention (h [B, 1, D]) over every slot of the
    caches [B, T, KH, hd] (this rank's kv heads where they split)."""
    params, q, k, v, tp = _cross_q(params, cfg, h, k_cache, v_cache, mesh)
    o = decode_attn(q, k, v, k.shape[1])
    return _attn_out(params, o, tp, mesh)


def gqa_decode_self_attn(params, cfg, x, k_cache, v_cache, pos, mesh=None):
    """x [B,1,D]; per-layer caches [B,T,KH,hd] (with ``mesh``, the kv
    heads this rank holds); pos [] absolute position (an int32 tensor).
    Returns (out [B,1,D], k_cache, v_cache): the caches are written in
    place (one slot; ``repro`` returns updated copies).  For SWA the cache
    is a rolling buffer of length == window."""
    b = x.shape[0]
    hd = cfg.hd
    sin, cos = rope_tables(pos[None], hd, cfg.rope_theta)
    params, (q, k, v), tp, kv = _tp_qkv(params, cfg, x, (sin, cos), mesh)
    if k.shape[2] != k_cache.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads into a cache of "
                         f"{k_cache.shape[2]}")
    t = k_cache.shape[1]
    slot = (pos % t) if cfg.sliding_window else torch.clamp(pos, max=t - 1)
    idx = slot.reshape(1).long()
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    kc, vc = (k_cache, v_cache) if kv is None else (k_cache[:, :, kv],
                                                    v_cache[:, :, kv])
    if cfg.sliding_window:
        # Rolling buffer: slot i holds absolute position pos - ((slot-i) % t),
        # valid iff non-negative.
        idx = torch.arange(t, device=x.device)
        age = (slot - idx) % t
        cache_pos = torch.where(age <= torch.clamp(pos, max=t - 1),
                                pos - age, -1)
        cache_pos = cache_pos[None, :].expand(b, t)
        o = decode_attn(q, kc, vc, None, cache_pos=cache_pos)
    else:
        o = decode_attn(q, kc, vc, pos + 1)
    return _attn_out(params, o, tp, mesh), k_cache, v_cache


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


def _mla_tp(params, cfg, mesh):
    """(this rank's MLA heads, whether it holds a block of them over
    "model"), from ``wuk``'s head columns."""
    h = params["wuk"]["w"].shape[-1] // cfg.qk_nope_dim
    return h, model_block(mesh, h, cfg.n_heads)


def _mla_params(params, mesh, sp, tp):
    """MLA's leaves, those a rank reads on its own tokens under ``sp``
    through ``layers.sp_tree``: the down projections, their norms and
    ``wkr``, and every other leaf too where the heads do not split."""
    if not sp:
        return params
    if not tp:
        return sp_tree(params, mesh)
    own = ("wdq", "q_norm", "wdkv", "kv_norm", "wkr")
    return {k: sp_tree(params[k], mesh, k in own)
            for k in own + ("wuq", "wuk", "wuv", "wo")}


def _mla_qkr(params, cfg, x, positions, mesh=None, sp=False):
    """Shared q / rope-key computation. x [B,S,D] (this rank's sequence
    block with ``sp``; ``positions`` the whole sequence's): q of this
    rank's heads (``wuq``'s head columns, its re-blocked piece under a
    mesh), and the rope key.  Under a mesh the latents are read whole on
    every rank (``wdq`` gathered whole: its q_lora columns split would
    need the norm summed over "model" and ``cq`` gathered), and ``cq``
    and ``kr`` feed this rank's heads through ``psum_bwd``; with ``sp``
    they are computed on the rank's tokens and all-gathered along the
    sequence (``cq`` only where the heads split: else q is the own
    tokens')."""
    b, s, _ = x.shape
    h, tp = _mla_tp(params, cfg, mesh)
    cq = rmsnorm(params["q_norm"], dense(params["wdq"], x), cfg.norm_eps)
    sin, cos = rope_tables(positions, cfg.qk_rope_dim, cfg.rope_theta)
    own = _rows((sin, cos), mesh) if sp else (sin, cos)
    if tp:
        cq = seq_gather(cq, mesh, sp)
    q = dense(params["wuq"], cq).reshape(
        b, cq.shape[1], h, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, *(own if cq.shape[1] == s else (sin, cos)))
    kr = dense(params["wkr"], x).reshape(b, s, 1, cfg.qk_rope_dim)
    kr = apply_rope(kr, *own)
    if sp or tp:
        kr = seq_gather(kr, mesh, sp)
    return q_nope, q_rope, kr, (sin, cos)


def _mla_ckv(params, cfg, x, tp, mesh, sp=False):
    """The normed latent c_kv of x, whole on every rank (``psum_bwd``
    where it feeds this rank's heads; with ``sp`` computed on the rank's
    tokens and all-gathered along the sequence)."""
    ckv = rmsnorm(params["kv_norm"], dense(params["wdkv"], x), cfg.norm_eps)
    return seq_gather(ckv, mesh, sp) if sp or tp else ckv


def mla_self_attn(params, cfg, x, *, positions, chunk_q, chunk_kv,
                  mesh=None, sp=False):
    """Training / prefill MLA in the expanded (naive) form, through
    ``blockwise_attn`` as in ``repro``; with ``mesh``, on this rank's
    heads where the blocks say so, and with ``sp`` on this rank's
    sequence block of x (see the module doc)."""
    b = x.shape[0]
    h, tp = _mla_tp(params, cfg, mesh)
    params = _mla_params(params, mesh, sp, tp)
    q_nope, q_rope, kr, _ = _mla_qkr(params, cfg, x, positions, mesh, sp)
    ckv = _mla_ckv(params, cfg, x, tp, mesh, sp)
    t = ckv.shape[1]
    k_nope = dense(params["wuk"], ckv).reshape(b, t, h, cfg.qk_nope_dim)
    v = dense(params["wuv"], ckv).reshape(b, t, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr.expand(b, t, h, cfg.qk_rope_dim)], dim=-1)
    o = blockwise_attn(q, k, v, causal=True, chunk_q=chunk_q,
                       chunk_kv=chunk_kv, q_offset=_q_offset(q, k, mesh))
    return _attn_out(params, o, tp, mesh, sp)


def mla_decode_self_attn(params, cfg, x, ckv, kr, pos, mesh=None):
    """Decode with the compressed cache (c_kv + k_rope) and absorbed mats.

    ckv: [B,T,kv_lora]; kr: [B,T,rope_d]; pos: [] absolute position (an
    int32 tensor).  Scores = q_nope W_uk^T . ckv + q_rope . k_rope;
    out = (P . ckv) W_uv, in f32.  Returns (out [B,1,D], ckv, kr): the
    caches are written in place (one slot; ``repro`` returns updated
    copies).  With ``mesh``, ``wuk`` / ``wuv`` are absorbed over this
    rank's heads against the whole cache, and ``wo``'s row block is
    summed over "model".
    """
    b = x.shape[0]
    h, tp = _mla_tp(params, cfg, mesh)
    q_nope, q_rope, kr_new, _ = _mla_qkr(params, cfg, x, pos[None], mesh)
    ckv_new = _mla_ckv(params, cfg, x, tp, mesh)
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
    out = _attn_out(params, o.reshape(b, 1, h, cfg.v_head_dim).to(x.dtype),
                    tp, mesh)
    return out, ckv, kr
