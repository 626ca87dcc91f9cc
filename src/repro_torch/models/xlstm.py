"""xLSTM blocks (port of src/repro/models/xlstm.py): mLSTM (matrix
memory, chunked-parallel) and sLSTM (scalar memory, sequential: the
xLSTM paper notes it is not parallelizable, so a Python loop over the
positions where ``repro`` scans).

mLSTM per head: exponential input gate i_t, forget gate f_t (sigmoid in
log space), matrix memory C in R^{dk x dv}, normalizer n in R^{dk},
running stabilizer m:

    C_t = f_t C_{t-1} + i_t k_t v_t^T        (stabilized by m_t)
    h_t = (q_t C_t) / max(|q_t n_t|, exp(-m_t))

Train / prefill use the chunkwise form (intra-chunk decay-masked
quadratic + carried (C, n, m) in f32, m from -inf), decode the recurrent
step.  The stabilizers' maxima are ``torch.amax`` / ``torch.maximum``,
whose gradients split ties as JAX's do; -inf only ever meets a finite
number, so neither the forward nor the gradient makes a NaN.

Where the port differs from ``repro``: the carried state's updates
(``"bshd,bshv,bsh->bhdv"``, ``"bshd,bsh->bhd"``) fold the scale into the
values first and contract two operands; the sLSTM takes its four
recurrent products as one batched product against the stacked
``r{z,i,f,o}`` ([h, dh, 4 dh], each output element the same sum);
no ``shard_act``.  ``k / sqrt(dk)`` is a division by sqrt(dk) rounded to
k's dtype, as ``repro``'s weakly typed scalar is.  The ``r*`` leaves
are f32 and read in f32, as ``repro`` reads them.

Under a mesh whose "model" axis splits the heads
(``sharding.rules.tp_layout``; xLSTM-1.3B's 4 heads split on a 4-way axis
and stay whole on a 16-way one), ``mlstm`` / ``slstm`` and their steps
work on this rank's heads: ``wq`` / ``wk`` / ``wv`` / ``wo_gate`` and
``w{z,i,f}`` are column blocks, ``wi`` / ``wf`` and ``r{z,i,f,o}`` whole
leaves cut to the rank's heads (``layers.model_part``), the norm over the
model width sums its squares over "model" (``layers.rmsnorm``), and the
rows of ``wo`` the rank's heads give are summed by ``layers.dense_rows``.
The sLSTM's ``wo`` is also its o gate's input projection (``repro``'s
spec replaces the gate's ``wo`` by the output's), so it is a whole leaf
there, cut to the rank's columns for the gate and to its rows for the
output.  The input enters through ``psum_bwd``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import psum_bwd
from repro_torch.models.layers import dense, dense_rows, dense_spec, \
    log_sigmoid, model_block, model_part, rmsnorm, rmsnorm_spec, sigmoid
from repro_torch.models.module import P

_GATES = ("z", "i", "f", "o")


def mlstm_spec(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    return {
        "wq": dense_spec(d, d, ("embed", "heads")),
        "wk": dense_spec(d, d, ("embed", "heads")),
        "wv": dense_spec(d, d, ("embed", "heads")),
        "wi": dense_spec(d, h, ("embed", None), bias=True),
        "wf": dense_spec(d, h, ("embed", None), bias=True),
        "wo_gate": dense_spec(d, d, ("embed", "heads")),
        "norm": rmsnorm_spec(d),
        "wo": dense_spec(d, d, ("heads", "embed")),
    }


def _heads(params, cfg, key, mesh):
    """(this rank's heads, whether it holds a block of them over
    ``mesh``'s "model" axis), from the columns of ``params[key]``."""
    hl = params[key]["w"].shape[-1] // (cfg.d_model // cfg.n_heads)
    return hl, model_block(mesh, hl, cfg.n_heads)


def _enter(x, tp, mesh):
    """The block input as this rank's heads read it (``psum_bwd`` under
    tensor parallelism)."""
    return psum_bwd(x, mesh, "model") if tp else x


def _mlstm_qkvif(params, cfg, x, mesh=None):
    """q, k, v [B, S, H, dk] and the gates' logs [B, S, H] f32 of x (this
    rank's heads under a mesh: ``wi`` / ``wf``, whole leaves, cut to its
    columns by ``layers.model_part``; x as ``_enter`` gives it)."""
    b, s, d = x.shape
    h, tp = _heads(params, cfg, "wq", mesh)
    dk = d // cfg.n_heads
    q = dense(params["wq"], x).reshape(b, s, h, dk)
    k = dense(params["wk"], x).reshape(b, s, h, dk)
    k = k / torch.tensor(math.sqrt(dk), dtype=k.dtype, device=k.device)
    v = dense(params["wv"], x).reshape(b, s, h, dk)
    wi, wf = params["wi"], params["wf"]
    if tp:
        wi, wf = ({"w": model_part(g["w"], mesh, 1, h),
                   "b": model_part(g["b"], mesh, 0, h)} for g in (wi, wf))
    log_i = dense(wi, x).float()                                    # [B,S,H]
    log_f = log_sigmoid(dense(wf, x).float())
    return q, k, v, log_i, log_f, dk


def _mlstm_out(params, cfg, x, y, mesh=None):
    """The block's output from the cell's y [B, S, H dk]: rmsnorm(y * the
    output gate), then ``wo`` (its row block summed over "model", the
    norm over the whole width, under tensor parallelism)."""
    o = sigmoid(dense(params["wo_gate"], x))
    return _norm_out(params, cfg, y * o, mesh)


def _norm_out(params, cfg, y, mesh):
    """``wo`` of rmsnorm(y) over the model width (``layers.rmsnorm``: a
    sum over "model" where y is this rank's heads, ``dense_rows`` then,
    of ``wo``'s row block, or of its rows cut from the whole leaf, the
    sLSTM's)."""
    d = cfg.d_model
    y = rmsnorm(params["norm"], y, cfg.norm_eps, mesh, d)
    if not model_block(mesh, y.shape[-1], d):
        return dense(params["wo"], y)
    wo = params["wo"]
    if wo["w"].shape[0] == d:
        wo = {"w": model_part(wo["w"], mesh, 0, y.shape[-1])}
    return dense_rows(wo, y, mesh)


def _mlstm_chunks(q, k, v, log_i, log_f, lc: int):
    """The chunkwise mLSTM from the zero state (m = -inf).  q, k, v [B, S,
    H, dk]; log_i, log_f [B, S, H] f32; S % lc == 0.  Returns h [B, S, H,
    dv] f32."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    C = q.new_zeros((b, h, dk, dv), dtype=torch.float32)
    n = q.new_zeros((b, h, dk), dtype=torch.float32)
    m = q.new_full((b, h), float("-inf"), dtype=torch.float32)
    above = ~torch.ones((lc, lc), dtype=torch.bool,
                        device=q.device).tril()[None, :, :, None]
    hs = []
    for c0 in range(0, s, lc):
        qq, kk, vv = (t[:, c0:c0 + lc].float() for t in (q, k, v))
        li, lf = log_i[:, c0:c0 + lc], log_f[:, c0:c0 + lc]
        csum = torch.cumsum(lf, dim=1)                              # [B,Lc,H]
        # Stabilizers per query position.
        m_inter = csum + m[:, None, :]                              # [B,Lc,H]
        dtil = (csum[:, :, None, :] - csum[:, None, :, :]
                + li[:, None, :, :]).masked_fill(above, float("-inf"))
        m_new = torch.maximum(m_inter, torch.amax(dtil, dim=2))
        dmat = torch.exp(dtil - m_new[:, :, None, :])               # [B,t,s,H]
        w = torch.einsum("bthd,bshd->btsh", qq, kk) * dmat
        scale_i = torch.exp(m_inter - m_new)                        # [B,Lc,H]
        h_num = torch.einsum("btsh,bshv->bthv", w, vv) \
            + scale_i[..., None] * torch.einsum("bthd,bhdv->bthv", qq, C)
        # Normalizer: q_t . n_t = sum_s w_ts + scale_i * (q_t . n_prev).
        qn = torch.einsum("bthd,bhd->bth", qq, n)
        qn_total = w.sum(dim=2) + scale_i * qn
        denom = torch.maximum(qn_total.abs(), torch.exp(-m_new))
        hs.append(h_num / denom[..., None])
        # Carry update.
        total = csum[:, -1]                                         # [B,H]
        decay = total[:, None, :] - csum + li                       # [B,Lc,H]
        m_c = torch.maximum(m + total, torch.amax(decay, dim=1))
        sc_old = torch.exp(m + total - m_c)
        sc_new = torch.exp(decay - m_c[:, None, :])
        C = sc_old[:, :, None, None] * C + torch.einsum(
            "bshd,bshv->bhdv", kk, vv * sc_new[..., None])
        n = sc_old[:, :, None] * n + torch.einsum("bshd,bsh->bhd", kk,
                                                  sc_new)
        m = m_c
    return torch.cat(hs, dim=1)


def mlstm(params, cfg, x, chunk: int = 128, mesh=None):
    """Train / prefill mLSTM.  x [B, S, D] -> [B, S, D]; S must be a
    multiple of min(chunk, S).  With ``mesh``, on this rank's heads where
    the blocks say so (see the module doc)."""
    b, s, d = x.shape
    lc = min(chunk, s)
    if s % lc:
        raise ValueError(f"mlstm: sequence length {s} is no multiple of "
                         f"the chunk {lc}")
    x = _enter(x, _heads(params, cfg, "wq", mesh)[1], mesh)
    q, k, v, log_i, log_f, _ = _mlstm_qkvif(params, cfg, x, mesh)
    y = _mlstm_chunks(q, k, v, log_i, log_f, lc)
    return _mlstm_out(params, cfg, x, y.reshape(b, s, -1).to(x.dtype), mesh)


def mlstm_init_state(cfg, batch, device=None, heads=None):
    """The zero state from m = -inf; ``heads``: this rank's (under a
    mesh, ``runtime.steps.local_cache``) or all of them."""
    h = heads or cfg.n_heads
    dk = cfg.d_model // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dk, dk), **f32),
            "n": torch.zeros((batch, h, dk), **f32),
            "m": torch.full((batch, h), float("-inf"), **f32)}


def mlstm_step(params, cfg, x, state, mesh=None):
    """Decode one token.  x [B, 1, D]; state {"C", "n", "m"} (this rank's
    heads under a mesh).  Returns (y [B, 1, D], the new state)."""
    b = x.shape[0]
    x = _enter(x, _heads(params, cfg, "wq", mesh)[1], mesh)
    q, k, v, log_i, log_f, _ = _mlstm_qkvif(params, cfg, x, mesh)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()  # [B,H,dk]
    li, lf = log_i[:, 0], log_f[:, 0]                              # [B,H]
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fs = torch.exp(lf + m - m_new)
    is_ = torch.exp(li - m_new)
    C = fs[:, :, None, None] * C \
        + is_[:, :, None, None] * (k[..., :, None] * v[..., None, :])
    n = fs[:, :, None] * n + is_[:, :, None] * k
    h_num = torch.einsum("bhd,bhdv->bhv", q, C)
    qn = torch.einsum("bhd,bhd->bh", q, n)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    y = (h_num / denom[..., None]).reshape(b, 1, -1).to(x.dtype)
    return _mlstm_out(params, cfg, x, y, mesh), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------- sLSTM
def slstm_spec(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    gates = {}
    for g in _GATES:
        gates[f"w{g}"] = dense_spec(d, d, ("embed", "heads"), bias=True)
        gates[f"r{g}"] = P((h, dh, dh), (None, None, None), init="fanin",
                           fan_in=dh)
    gates["norm"] = rmsnorm_spec(d)
    gates["wo"] = dense_spec(d, d, ("heads", "embed"))
    return gates


def _slstm_pre(params, cfg, x, mesh=None):
    """The gates' input projections [B, S, h, 4, dh] f32 (z, i, f, o) and
    the stacked recurrent matrices [h, dh, 4 dh] f32, for this rank's h
    heads under a mesh (the ``r*`` leaves, whole, cut to them by
    ``layers.model_part``; x as ``_enter`` gives it)."""
    b, s, d = x.shape
    h, tp = _heads(params, cfg, "wz", mesh)
    ws = [params[f"w{g}"] for g in _GATES]
    rs = [params[f"r{g}"] for g in _GATES]
    if tp:
        # ``wo`` (the o gate's and the output's, see the module doc) is
        # whole: the gate reads its heads' columns.
        ws[3] = {"w": model_part(ws[3]["w"], mesh, 1, h * d //
                                 cfg.n_heads)}
        rs = [model_part(r, mesh, 0, h) for r in rs]
    pre = torch.stack([dense(w, x).reshape(b, s, h, d // cfg.n_heads)
                       for w in ws], dim=3).float()
    rec = torch.cat([r.float() for r in rs], dim=-1)
    return pre, rec


def _slstm_cell(gates, c, n, m):
    """One sLSTM step from the gates' pre-activations [..., 4 dh] (input
    projection + recurrent product; z, i, f, o along the last axis).
    Returns (c, n, h, m)."""
    pz, li, pf, po = gates.chunk(4, dim=-1)
    z = torch.tanh(pz)
    lf = log_sigmoid(pf)
    o = sigmoid(po)
    lfm = lf + m
    m_new = torch.maximum(lfm, li)
    i_ = torch.exp(li - m_new)
    f_ = torch.exp(lfm - m_new)
    c = f_ * c + i_ * z
    n = f_ * n + i_
    return c, n, o * c / torch.maximum(n.abs(), n.new_ones(())), m_new


def slstm(params, cfg, x, mesh=None):
    """x [B, S, D] -> [B, S, D], one position at a time (the state in [h,
    B, dh], so each step's recurrent product is one batched matmul).
    With ``mesh``, on this rank's heads where the blocks say so: the
    recurrence is block-diagonal by head, so the loop holds no
    collective; the norm's one sum over "model" comes after it."""
    b, s, d = x.shape
    x = _enter(x, _heads(params, cfg, "wz", mesh)[1], mesh)
    pre, rec = _slstm_pre(params, cfg, x, mesh)
    h, dh = pre.shape[2], d // cfg.n_heads
    pre = pre.permute(1, 2, 0, 3, 4).reshape(s, h, b, 4 * dh)
    c = n = hprev = pre.new_zeros(pre.shape[1:-1] + (dh,))
    m = torch.full_like(c, float("-inf"))
    hs = []
    for t in range(s):
        c, n, hprev, m = _slstm_cell(torch.baddbmm(pre[t], hprev, rec),
                                     c, n, m)
        hs.append(hprev)
    y = torch.stack(hs, dim=2).permute(1, 2, 0, 3).reshape(b, s, h * dh)
    return _norm_out(params, cfg, y.to(x.dtype), mesh)


def slstm_init_state(cfg, batch, device=None, heads=None):
    """The zero state from m = -inf; ``heads`` as ``mlstm_init_state``'s."""
    h = heads or cfg.n_heads
    dh = cfg.d_model // cfg.n_heads
    z = torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full_like(z, float("-inf"))}


def slstm_step(params, cfg, x, state, mesh=None):
    """Decode one token.  x [B, 1, D]; state {"c", "n", "h", "m"} [B, h,
    dh] (this rank's heads under a mesh).  Returns (y [B, 1, D], the new
    state)."""
    b = x.shape[0]
    x = _enter(x, _heads(params, cfg, "wz", mesh)[1], mesh)
    pre, rec = _slstm_pre(params, cfg, x, mesh)
    gates = pre[:, 0].flatten(2) + torch.einsum("bhd,hde->bhe", state["h"],
                                                rec)
    c, n, hnew, m = _slstm_cell(gates, state["c"], state["n"], state["m"])
    y = _norm_out(params, cfg, hnew.reshape(b, 1, -1).to(x.dtype), mesh)
    return y, {"c": c, "n": n, "h": hnew, "m": m}
