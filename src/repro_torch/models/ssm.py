"""Mamba2 (SSD) block (port of src/repro/models/ssm.py): the chunked
parallel scan for training / prefill, the recurrent state update for
decode.

Per head h the SSD recurrence with scalar decay a_t = exp(-exp(A_log_h) *
softplus(dt_t + dt_bias_h)) is

    S_t = a_t * S_{t-1} + B_t (dt_t x_t)^T          S in R^{N x P}
    y_t = C_t . S_t + D_h x_t

Chunked form (chunk length Lc, a Python loop over the chunks where
``repro`` scans): intra-chunk a decay-masked quadratic product, inter-
chunk a rank-N state carried across chunks in f32.

Where the port differs from ``repro``, and why:

* the intra-chunk decay is masked in the exponent (exp(-inf) = 0 above
  the diagonal).  ``repro`` takes exp of the unmasked difference and
  multiplies the upper triangle by 0: above the diagonal the exponent is
  positive, and once a chunk's summed decay exceeds ~88 (at ``repro``'s
  default chunk of 256 and a_log = 0, softplus(0) = 0.69 a step: past
  128 steps) exp overflows to inf and inf * 0 = NaN.  Below the diagonal
  the two agree bit for bit;
* the carried state's update ``"bsn,bshp,bsh->bhnp"`` folds the decay
  into the values first and contracts two operands, so no installation
  builds the [B, Lc, H, N, P] product first;
* no ``shard_act``: it is the identity in the port (``layers.shard_act``).

Under a mesh whose "model" axis splits the heads
(``sharding.rules.tp_layout``: "heads carry TP", as ``repro``'s Mamba2
says), ``mamba2`` / ``mamba2_step`` work on this rank's heads: z, x and
dt from its piece of ``in_proj`` (re-blocked: its heads' columns and the
B / C ones whole), the depthwise conv over its x channels and the B / C
ones, the SSD scan over its heads unchanged, the gated norm's sum of
squares summed over "model" (``layers.rmsnorm``), and ``out_proj``'s row
block summed by ``layers.dense_rows``.  The input enters through
``psum_bwd``, and so does each whole leaf a rank reads in part.

``repro``'s bf16 roundings are kept: the chunked form takes dt * x in
bf16 (dt rounded first), the step in f32; the depthwise conv sums its
taps in x's dtype one tap at a time, oldest first.  ``conv_w``,
``conv_b``, ``a_log``, ``d_skip`` and ``dt_bias`` are f32 leaves cast
per call, as ``repro`` casts them.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import psum_bwd
from repro_torch.models.ffn import silu
from repro_torch.models.layers import dense, dense_rows, dense_spec, \
    model_block, model_part, rmsnorm, rmsnorm_spec, softplus
from repro_torch.models.module import P


def mamba2_spec(cfg, d_in=None):
    d = d_in or cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = di // cfg.ssm_head_dim
    conv_dim = di + 2 * n           # x, B, C go through the causal conv
    return {
        "in_proj": dense_spec(d, 2 * di + 2 * n + h, ("embed", "mlp")),
        "conv_w": P((conv_dim, cfg.ssm_conv), (None, None), init="fanin",
                    fan_in=cfg.ssm_conv),
        "conv_b": P((conv_dim,), (None,), init="zeros"),
        "a_log": P((h,), (None,), init="zeros"),
        "d_skip": P((h,), (None,), init="ones"),
        "dt_bias": P((h,), (None,), init="zeros"),
        "norm": rmsnorm_spec(di),
        "out_proj": dense_spec(di, d, ("mlp", "embed")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x [B, S, C]; w [C, K]; state [B, K-1, C] or
    None (zeros).  Tap j multiplies ``xp[:, j:j+S]`` (tap 0 the oldest
    input).  Returns (y [B, S, C], new_state [B, K-1, C])."""
    k = w.shape[1]
    s = x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = xp[:, :s] * w[:, 0].to(x.dtype)
    for j in range(1, k):
        y = y + xp[:, j:j + s] * w[:, j].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(k - 1):]


def _heads(params, cfg, d_in, mesh):
    """(this rank's heads, the whole count, whether it holds a block of
    them over ``mesh``'s "model" axis), from ``out_proj``'s rows."""
    h = cfg.ssm_expand * d_in // cfg.ssm_head_dim
    hl = params["out_proj"]["w"].shape[0] // cfg.ssm_head_dim
    return hl, h, model_block(mesh, hl, h)


def _split_in_proj(params, cfg, x, d_in, mesh=None):
    """z, x, B, C, dt of x [B, S, D] and their widths: this rank's heads'
    z / x / dt and the B / C columns whole under a mesh (``in_proj`` is
    its re-blocked piece there, x enters through ``psum_bwd``)."""
    hl, _, tp = _heads(params, cfg, d_in, mesh)
    dl, n = hl * cfg.ssm_head_dim, cfg.ssm_state
    if tp:
        x = psum_bwd(x, mesh, "model")
    zxbcdt = dense(params["in_proj"], x)
    z, xs, bb, cc, dt = torch.split(zxbcdt, [dl, dl, n, n, hl], dim=-1)
    return z, xs, bb, cc, dt, dl, n, hl


def _parts(params, cfg, d_in, mesh):
    """The whole leaves a rank reads in part: the conv's weights and bias
    at its x channels and the B / C ones, ``a_log`` / ``d_skip`` /
    ``dt_bias`` at its heads (``layers.model_part``); as they are
    without a "model" block."""
    keys = ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias")
    hl, h, tp = _heads(params, cfg, d_in, mesh)
    if not tp:
        return {k: params[k] for k in keys}
    di, dl = h * cfg.ssm_head_dim, hl * cfg.ssm_head_dim
    out = {k: model_part(params[k], mesh, 0, hl) for k in keys[2:]}
    for k in keys[:2]:
        t = psum_bwd(params[k], mesh, "model")
        out[k] = torch.cat([t.narrow(0, mesh.index("model") * dl, dl),
                            t.narrow(0, di, t.shape[0] - di)])
    return out


def _gated_out(params, cfg, y, z, mesh=None):
    """The block's output: rmsnorm(y * silu(z)), then ``out_proj``; under
    a mesh the norm's sum of squares over "model" (``layers.rmsnorm``)
    and ``out_proj``'s row block summed by ``dense_rows``."""
    di = params["norm"]["scale"].shape[-1]
    y = rmsnorm(params["norm"], y * silu(z), cfg.norm_eps, mesh, di)
    if model_block(mesh, y.shape[-1], di):
        return dense_rows(params["out_proj"], y, mesh)
    return dense(params["out_proj"], y)


def _ssd_chunks(xt, bb, cc, log_a, lc: int):
    """The chunked scan from a zero state.  xt [B, S, H, P] (dt * x), bb /
    cc [B, S, N], log_a [B, S, H] f32 (<= 0); S % lc == 0.  Returns y
    [B, S, H, P] f32 (without the D skip)."""
    b, s, h, p = xt.shape
    n = bb.shape[-1]
    state = xt.new_zeros((b, h, n, p), dtype=torch.float32)
    above = ~torch.ones((lc, lc), dtype=torch.bool,
                        device=xt.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, s, lc):
        xtc = xt[:, c0:c0 + lc].float()
        bc = bb[:, c0:c0 + lc].float()
        ccc = cc[:, c0:c0 + lc].float()
        csum = torch.cumsum(log_a[:, c0:c0 + lc], dim=1)            # [B,Lc,H]
        cb = torch.einsum("btn,bsn->bts", ccc, bc)
        seg = csum[:, :, None, :] - csum[:, None, :, :]             # [B,t,s,H]
        dec = torch.exp(seg.masked_fill(above, float("-inf")))
        y_intra = torch.einsum("btsh,bshp->bthp", cb[..., None] * dec, xtc)
        y_inter = torch.einsum("btn,bhnp->bthp", ccc, state) \
            * torch.exp(csum)[..., None]
        to_end = torch.exp(csum[:, -1:, :] - csum)                  # [B,Lc,H]
        s_c = torch.einsum("bsn,bshp->bhnp", bc, xtc * to_end[..., None])
        state = torch.exp(csum[:, -1])[:, :, None, None] * state + s_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)


def mamba2(params, cfg, x, chunk: int = 128, d_in=None, mesh=None):
    """Train / prefill.  x [B, S, D] -> [B, S, D]; S must be a multiple of
    min(chunk, S).  With ``mesh``, on this rank's heads where the blocks
    say so (see the module doc)."""
    b, s, d = x.shape
    lc = min(chunk, s)
    if s % lc:
        raise ValueError(f"mamba2: sequence length {s} is no multiple of "
                         f"the chunk {lc}")
    z, xs, bb, cc, dt, di, n, h = _split_in_proj(params, cfg, x, d_in or d,
                                                 mesh)
    w = _parts(params, cfg, d_in or d, mesh)
    p = cfg.ssm_head_dim

    conv_in = torch.cat([xs, bb, cc], dim=-1)
    conv_out, _ = _causal_conv(conv_in, w["conv_w"], w["conv_b"])
    xs, bb, cc = torch.split(silu(conv_out), [di, n, n], dim=-1)

    dt = softplus(dt.float() + w["dt_bias"].float())               # [B,S,H]
    log_a = -torch.exp(w["a_log"].float()) * dt                      # <= 0
    xh = xs.reshape(b, s, h, p)
    xt = xh * dt[..., None].to(xh.dtype)                             # dt * x

    y = _ssd_chunks(xt, bb, cc, log_a, lc)
    y = y + w["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, di).to(x.dtype)
    return _gated_out(params, cfg, y, z, mesh)


def mamba2_init_state(cfg, batch, d_in, dtype=torch.float32, device=None,
                      heads=None):
    """Zeros: ``S`` [B, H, N, P] f32 and ``conv`` [B, K-1, H P + 2 N]; H
    is ``heads`` (this rank's under a mesh, ``runtime.steps.local_cache``)
    or all of them."""
    h = heads or cfg.ssm_expand * d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    return {
        "S": torch.zeros((batch, h, n, cfg.ssm_head_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             h * cfg.ssm_head_dim + 2 * n),
                            dtype=dtype, device=device),
    }


def mamba2_step(params, cfg, x, state, d_in=None, mesh=None):
    """Decode one token.  x [B, 1, D]; state {"S", "conv"} (this rank's
    heads under a mesh).  Returns (y [B, 1, D], the new state: "S" f32,
    "conv" in x's dtype)."""
    b, _, d = x.shape
    z, xs, bb, cc, dt, di, n, h = _split_in_proj(params, cfg, x, d_in or d,
                                                 mesh)
    w = _parts(params, cfg, d_in or d, mesh)
    p = cfg.ssm_head_dim
    conv_in = torch.cat([xs, bb, cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, w["conv_w"], w["conv_b"],
                                        state["conv"].to(conv_in.dtype))
    xs, bb, cc = torch.split(silu(conv_out), [di, n, n], dim=-1)
    dt = softplus(dt.float() + w["dt_bias"].float())[:, 0]          # [B,H]
    a = torch.exp(-torch.exp(w["a_log"].float()) * dt)
    xh = xs.reshape(b, h, p).float()
    xt = xh * dt[..., None]
    S = a[:, :, None, None] * state["S"] \
        + bb[:, 0].float()[:, None, :, None] * xt[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", cc[:, 0].float(), S)
    y = y + w["d_skip"].float()[None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    return _gated_out(params, cfg, y, z, mesh), {"S": S, "conv": conv_state}
