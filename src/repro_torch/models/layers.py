"""Shared layers: norms, embeddings, RoPE, dense (port of
src/repro/models/layers.py).

The upcasts are ``repro``'s, op for op: ``rmsnorm`` / ``layernorm`` and
``apply_rope`` compute in f32 and cast back, ``unembed`` gives f32
logits, ``dense`` casts ``w`` and ``b`` to the activation dtype.  A
product that ``repro`` takes in bf16 with an f32 result
(``preferred_element_type``) is taken here on f32 copies of the bf16
operands, which is the same arithmetic.  ``act_spec`` is ``repro``'s
(the spec ``shard_act`` would pin); ``shard_act`` is the identity (see
its doc).  ``params`` is a ``ParamTree`` or a plain dict of tensors.

The sequence-parallel residual (Megatron's SP, what GSPMD makes of
``repro``'s ``shard_act(x, BATCH, "model", None)`` at every transformer
block): where ``seq_parallel`` holds, each rank of the "model" axis
holds its sequence block [B, S / m, D] of the residual between
sublayers (``seq_block`` cuts it from a whole one), a column-parallel
product reads the stream all-gathered along the sequence
(``gather_fwd``), and a row-parallel one leaves by a reduce-scatter
along it (``dense_rows(..., sp=True)``); a leaf every rank holds whole
and reads on its own tokens only (a norm's scale, a gate, the
projections of heads that do not split) enters through ``sp_tree``.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import block_fwd, gather_fwd, psum_bwd, \
    psum_fwd, scatter_fwd
from repro_torch.models.module import P, tree_map

ACT_DTYPE = torch.bfloat16

BATCH = ("pod", "data")


def act_spec(shape, parts, mesh):
    """The PartitionSpec ``repro``'s ``shard_act`` would apply to ``shape``
    on ``mesh``.

    Axis names absent from the mesh are dropped; entries whose dimension
    is not divisible by the assigned mesh extent are replicated (e.g. 4
    kv heads on a 16-way model axis).  ``mesh`` only needs ``axis_names``
    and a name->size ``shape`` mapping (Mesh, AbstractMesh, or a test
    stub).
    """
    from repro_torch.sharding.rules import PartitionSpec
    names = set(mesh.axis_names)

    def extent(axes):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        return n

    spec = []
    for dim, p in zip(shape, parts):
        if p is None:
            spec.append(None)
            continue
        axes = tuple(a for a in ((p,) if isinstance(p, str) else p)
                     if a in names)
        if axes and dim % extent(axes) == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def shard_act(x, *parts):
    """The identity.  In ``repro`` a sharding constraint for GSPMD, which
    changes no value.  The port lays its activations out itself: they
    are this rank's rows (``runtime.steps`` splits the batch over
    ``BATCH``); where GSPMD shards heads, mlp and vocab over "model" the
    families compute on their parameter blocks
    (``sharding.rules.tp_layout``; the attention, ``ffn`` and the head
    read the blocks' shapes); and where ``repro`` pins the residual to
    [BATCH, "model", None] the blocks hold its sequence block
    (``seq_parallel``, ``seq_block``; the module doc)."""
    return x


def seq_parallel(mesh, s: int) -> bool:
    """Whether a residual [B, s, D] is sequence-parallel on ``mesh``: the
    "model" axis is on it, longer than 1, and ``act_spec`` puts it on
    the sequence (it divides ``s``), as ``repro``'s pin
    ``shard_act(x, BATCH, "model", None)`` does.  Decode's one token and
    a prompt the axis does not divide keep the residual whole."""
    if mesh is None or "model" not in mesh.axis_names \
            or mesh.shape["model"] == 1:
        return False
    return act_spec((1, s, 1), (None, "model", None), mesh)[1] == "model"


def seq_block(x, mesh):
    """(x, sp): this rank's sequence block [B, S / m, D] of a residual x
    [B, S, D] every rank of "model" holds whole, and True, where
    ``seq_parallel(mesh, S)``; else x itself and False.  The block's
    backward all-gathers the gradient (``block_fwd``)."""
    sp = seq_parallel(mesh, x.shape[1])
    return (block_fwd(x, mesh, "model", 1) if sp else x), sp


def seq_whole(x, mesh, sp: bool):
    """The whole residual [B, S, D] of this rank's sequence block x (an
    all-gather along the sequence; the backward takes this rank's block
    of the gradient, which every rank holds whole) where ``sp``; else
    x."""
    return gather_fwd(x, mesh, "model", 1, reduce=False) if sp else x


def seq_gather(x, mesh, sp: bool):
    """The whole sequence of a sequence block x that enters this rank's
    heads or columns (an all-gather whose backward reduce-scatters each
    rank's partial gradient) where ``sp``; else x through ``psum_bwd``
    (whole on every rank already)."""
    if sp:
        return gather_fwd(x, mesh, "model", 1, reduce=True)
    return psum_bwd(x, mesh, "model")


def sp_tree(params, mesh, sp: bool = True):
    """``params`` (a leaf, or a tree of leaves every rank of "model"
    holds whole) with each leaf through ``psum_bwd`` where ``sp``: read
    on this rank's tokens only, each rank's gradient is a share."""
    if not sp:
        return params
    if isinstance(params, torch.Tensor):
        return psum_bwd(params, mesh, "model")
    return tree_map(lambda t: psum_bwd(t, mesh, "model"),
                    _as_dict(params))


def _as_dict(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    keys = list(tree._parameters) + list(tree._modules) \
        if isinstance(tree, torch.nn.Module) else list(tree)
    return {k: _as_dict(tree[k]) for k in keys}


def model_block(mesh, local: int, whole: int) -> bool:
    """Whether a dimension that is ``local`` long here and ``whole`` long
    in the config is this rank's block over ``mesh``'s "model" axis (False
    when it is whole); raises when it is neither."""
    if local == whole:
        return False
    if mesh is None or "model" not in mesh.axis_names \
            or local * mesh.shape["model"] != whole:
        raise ValueError(f"a block of {local} of {whole} is no 'model' "
                         f"block of mesh {getattr(mesh, 'shape', None)}")
    return True


def rmsnorm_spec(d):
    return {"scale": P((d,), (None,), init="ones")}


def rmsnorm(params, x, eps=1e-5, mesh=None, d=None):
    """RMSNorm over the last axis in f32.  With ``d`` (the whole width)
    and an x that is this rank's block of it over ``mesh``'s "model" axis
    (a norm over heads the rank splits: Mamba2's gated norm, the mLSTM's
    and sLSTM's), the sum of squares of the block is summed over "model"
    and divided by ``d``, and the whole ``scale`` leaf is cut to the
    block (through ``psum_bwd``: each rank's gradient covers its block).
    Each rank's normalized block reads the one total, so the total's
    gradient is summed over "model" too (``psum_fwd`` then ``psum_bwd``:
    an all-reduce both ways; Megatron's g alone would pass each rank its
    partial)."""
    dt = x.dtype
    scale = params["scale"]
    if d is None or not model_block(mesh, x.shape[-1], d):
        x = x.float()
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + eps)
        return (x * scale).to(dt)
    n = x.shape[-1]
    x = x.float()
    ss = torch.sum(torch.square(x), dim=-1, keepdim=True)
    ss = psum_bwd(psum_fwd(ss, mesh, "model"), mesh, "model")
    x = x * torch.rsqrt(ss / d + eps)
    return (x * model_part(scale, mesh, 0, n)).to(dt)


def model_part(t, mesh, dim: int, n: int):
    """This rank's ``n`` entries along ``dim`` of ``t``, a leaf every rank
    of ``mesh``'s "model" axis holds whole and reads only in part (rank i
    the i-th run of ``n``): entered through ``psum_bwd``, so the rank's
    gradient of the whole leaf is the sum of every rank's part."""
    t = psum_bwd(t, mesh, "model")
    return t.narrow(dim, mesh.index("model") * n, n)


def layernorm_spec(d):
    return {"scale": P((d,), (None,), init="ones"),
            "bias": P((d,), (None,), init="zeros")}


def layernorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"] + params["bias"]).to(dt)


def embed_spec(vocab, d):
    return {"table": P((vocab, d), ("vocab", "embed"), init="normal")}


def embed(params, tokens, mesh=None, vocab=None, sp=False):
    """The rows of ``tokens``: gather, then cast (the same bits as
    ``repro``'s cast-then-gather without casting the whole table).  Where
    the table is this rank's vocab block of ``vocab`` rows (``mesh``'s
    "model" axis), the rank looks up the tokens in its range, puts zeros
    elsewhere and sums over "model": exactly one process's rows.  With
    ``sp`` the rows are this rank's sequence block (``seq_parallel``):
    the vocab block's rows leave by a reduce-scatter along the sequence,
    whole rows are cut (``seq_block``)."""
    table = params["table"]
    if vocab is None or not model_block(mesh, table.shape[0], vocab):
        rows = table[tokens].to(ACT_DTYPE)
        return block_fwd(rows, mesh, "model", 1) if sp else rows
    n = table.shape[0]
    idx = tokens.long() - mesh.index("model") * n
    mine = (idx >= 0) & (idx < n)
    rows = table[torch.where(mine, idx, 0)].to(ACT_DTYPE)
    rows = rows.masked_fill(~mine[..., None], 0)
    if sp:
        return scatter_fwd(rows, mesh, "model", 1)
    return psum_fwd(rows, mesh, "model")


def unembed_spec(vocab, d):
    return {"w": P((d, vocab), ("embed", "vocab"), init="fanin", fan_in=d)}


def unembed(params, x):
    # Logits in f32 for a stable softmax / argmax.
    return x.float() @ params["w"].float()


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions [S] (or [B, S]) -> (sin, cos) [..., S, dim/2] f32."""
    assert dim % 2 == 0
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x [..., S, H, D]; sin/cos [S, D/2] or [B, S, D/2] (broadcast over H)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if sin.dim() == 2:   # [S, D/2] -> broadcast over batch and heads
        s = sin[None, :, None, :]
        c = cos[None, :, None, :]
    else:                # [B, S, D/2]
        s = sin[:, :, None, :]
        c = cos[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA expands it: 1 / (1 + exp(-x)), each op in
    x's dtype (in bf16 each rounds, as ``repro``'s do)."""
    return 1.0 / (1.0 + torch.exp(-x))


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) (``F.softplus`` returns x above
    its threshold of 20 instead)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def dense_spec(d_in, d_out, axes, bias=False, init="fanin"):
    s = {"w": P((d_in, d_out), axes, init=init, fan_in=d_in)}
    if bias:
        s["b"] = P((d_out,), (axes[1],), init="zeros")
    return s


def dense(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def dense_rows(params, x, mesh, sp=False):
    """``dense`` of this rank's columns of ``x`` by its row block of
    ``w`` (no bias), summed over ``mesh``'s "model" axis (Megatron's g):
    each partial product rounded to x's dtype (bf16), the partials added
    in f32 and the sum rounded once, as XLA lowers ``repro``'s
    partitioned ``dense`` (a bf16 partial, an all-reduce promoted to
    f32).  The f32 sum of a few bf16 values is exact but for far-apart
    exponents, so it does not depend on the collective's order.  With
    ``sp`` (x [B, S, .] over the whole sequence, ``seq_parallel``) the
    f32 partials are reduce-scattered along the sequence instead, each
    rank keeping its block [B, S / m, D]: the bits of the all-reduce's
    rows."""
    part = (x @ params["w"].to(x.dtype)).float()
    if sp:
        return scatter_fwd(part, mesh, "model", 1).to(x.dtype)
    return psum_fwd(part, mesh, "model").to(x.dtype)
