"""Logical-axis -> mesh-axis sharding rules (port of
src/repro/sharding/rules.py), and the placement of parameters and batches
on a ``launch.mesh.Mesh``.

Parameters declare logical axes in their ``P`` spec; the rules resolve
them against a mesh, as ``repro``'s do.  A rule is silently dropped
(replicated) when the dimension is not divisible by the assigned mesh
extent, e.g. GQA kv-head counts smaller than the model axis.

Weight strategy (DESIGN.md §5):
  tensor-parallel axes (vocab, heads, mlp, experts, q_lora) -> "model"
  FSDP axis (embed / the non-TP matmul dim)                 -> "data"
The batch is split on ("pod", "data").

The port has no GSPMD to place arrays, so the rules return the port's
own ``PartitionSpec`` (a tuple holding, per dimension, None, an axis name
or a tuple of names) inside a ``NamedSharding(mesh, spec)``, and this
module places tensors by them: ``local_shard`` is this rank's block of a
full tensor (``NamedSharding.devices_indices_map``'s slice for its
device), ``shard_params`` / ``gather_params`` map a tree to its blocks and
back, ``split_batch`` takes this rank's rows of a batch.  A mesh here is
anything with ``axis_names`` and a name -> size ``shape`` (``Mesh``,
``AbstractMesh``, a test stub); placing a tensor also reads ``coords``.

The port's models hold one parameter per layer (``blocks.3.attn.wq.w``)
where ``repro`` stacks the layers (``blocks/attn/wq/w`` [L, ...]);
``model_shardings`` gives each the spec of its stacked leaf less the
stacked dimensions, which the rules never shard ("layers" and "groups"
map to no mesh axis).  Weights are carried across as
``params_from_numpy`` (or ``init_params_into``) on a full model, then
``shard_params``; ``init_sharded`` draws them leaf by leaf straight into
the shards.

``tp_layout`` / ``tp_block`` / ``tp_leaves`` / ``tp_pieces`` are the
tensor-parallel rule of every family: which leaves a rank computes on as
its "model" block (the attention's heads, self, cross, MLA's and
zamba2's shared block's, the FFN's and the shared experts' width, the
Mamba2 and xLSTM heads, the vocab), and which it computes on as a piece
of a re-blocked leaf (MLA's ``wuq``, Mamba2's ``in_proj``: ``repro``'s
block is not the one the rank computes on), decided from these rules
and the config alone; ``runtime.steps`` keeps those blocks and pieces in
the compute tree and ``local_cache`` splits the cache's kv heads as
``cache_shardings`` does and the recurrent state by the heads a rank
computes (not ``cache_shardings``' axis: ROADMAP §3).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.module import P, _per_layer, _init_one, flatten, \
    tree_map

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "q_lora": ("model",),
    "embed": ("data",),          # FSDP / ZeRO-3 weight sharding
    "moe_mlp": (),
    "kv_lora": (),
    "layers": (),
    "groups": (),
}

BATCH_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """Per dimension: None (replicated), an axis name, or a tuple of axis
    names (the dimension split over their product, row-major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    mesh: object
    spec: PartitionSpec


def mesh_extent(mesh, axes: tuple[str, ...]) -> int:
    return int(math.prod(mesh.shape[a] for a in axes))


def spec_pspec(p: P, mesh, rules=None) -> PartitionSpec:
    rules = rules or DEFAULT_RULES
    used: set[str] = set()
    parts = []
    for dim, ax in zip(p.shape, p.axes):
        assign = tuple(rules.get(ax, ())) if ax else ()
        assign = tuple(a for a in assign
                       if a in mesh.axis_names and a not in used)
        if assign and mesh_extent(mesh, assign) > 1 \
                and dim % mesh_extent(mesh, assign) == 0:
            parts.append(assign if len(assign) > 1 else assign[0])
            used.update(assign)
        else:
            parts.append(None)
    return PartitionSpec(*parts)


def param_shardings(specs, mesh, rules=None):
    """``NamedSharding`` tree for a spec tree (``repro``'s layout, the
    stacks unsplit).  The port has no ambient mesh: ``mesh`` is
    required."""
    if mesh is None:
        raise ValueError("param_shardings: no mesh (the port has no "
                         "ambient mesh)")
    return tree_map(lambda p: NamedSharding(mesh, spec_pspec(p, mesh,
                                                             rules)), specs)


def model_shardings(model, mesh, rules=None) -> dict:
    """{parameter name: NamedSharding} of a port model (one parameter per
    layer): each stacked leaf's spec less its stacked dimensions."""
    out = {}
    for name, p in flatten(model.specs).items():
        spec = spec_pspec(p, mesh, rules)
        meta = torch.empty(p.shape, device="meta")
        for pname, part in _per_layer(name, meta, model):
            lead = len(p.shape) - part.dim()
            if any(spec[:lead]):
                raise ValueError(f"{name}: a stacked dimension is sharded "
                                 f"({spec})")
            out[pname] = NamedSharding(mesh, PartitionSpec(*spec[lead:]))
    return out


# ------------------------------------------------------ tensor parallelism
# Every family computes tensor-parallel over "model" (Megatron's column /
# row layout) where the rules put its heads, FFN width or vocab there and
# the split falls on whole heads.
TP_FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm_hybrid", "xlstm")

# An attention's leaf (the last two names) -> (the ``TPLayout`` field it
# is split by, the dimension that field's rule puts on "model"), under
# any of the attention prefixes: "attn" (the self blocks', the vlm's
# cross blocks', zamba2's shared block's, DeepSeek-V2's dense layer's),
# "self" and "cross" (the encdec decoder's).
_ATTN_LEAVES = {
    "wq.w": ("heads", 1), "wq.b": ("heads", 0), "wo.w": ("heads", 0),
    "wk.w": ("kv_heads", 1), "wk.b": ("kv_heads", 0),
    "wv.w": ("kv_heads", 1), "wv.b": ("kv_heads", 0),
}
_ATTN_PREFIXES = ("attn", "self", "cross")
# Leaf (name suffix, the layer indices dropped) -> (field, dimension).
_TP_LEAVES = {
    **{f"{pre}.{k}": v for pre in _ATTN_PREFIXES
       for k, v in _ATTN_LEAVES.items()},
    # MLA: the up-projections' head columns (wo as above).
    "attn.wuk.w": ("heads", 1), "attn.wuv.w": ("heads", 1),
    "ffn.w_gate.w": ("ffn", 1), "ffn.w_up.w": ("ffn", 1),
    "ffn.w_down.w": ("ffn", 0),
    "moe.shared.w_gate.w": ("shared_ffn", 1),
    "moe.shared.w_up.w": ("shared_ffn", 1),
    "moe.shared.w_down.w": ("shared_ffn", 0),
    # Mamba2: rows of di, contiguous by head; zamba2's LoRA on q.
    "out_proj.w": ("ssm_heads", 0), "lora.b_q": ("heads", 1),
    "embed.table": ("vocab", 0), "unembed.w": ("vocab", 1),
}
# The xLSTM's blocks (mLSTM under "mlstms" or a flat "blocks" stack, the
# sLSTM under "slstm"): their leaves' names carry no attention prefix.
# The sLSTM's ``wo`` is both its o gate's input projection (its head
# columns) and its output projection (its head rows), as in ``repro``,
# whose spec's ``wo`` replaces the gate's: a whole leaf read in part.
_XLSTM_LEAVES = {
    **{k: ("heads", 1) for k in ("wq.w", "wk.w", "wv.w", "wo_gate.w")},
    **{f"slstm.w{g}.{p}": ("heads", 1 if p == "w" else 0)
       for g in "zif" for p in "wb"},
    "slstm.wo.w": None, "wo.w": ("heads", 0),
    "embed.table": ("vocab", 0), "unembed.w": ("vocab", 1),
}
# Re-blocked leaves: ``repro``'s block is not the one their consumer
# computes on (MLA's ``wuq`` puts its q_lora rows on "model", so its
# head columns cannot take it; Mamba2's ``in_proj`` splits the columns of
# [z | x | B | C | dt] contiguously, off the heads).  ``_compute_tree``
# gathers them over "model" and cuts this rank's piece (``tp_pieces``).
_TP_PIECES = {"attn.wuq.w": ("heads", 1), "in_proj.w": ("ssm_heads", 1)}


class TPLayout(NamedTuple):
    """What one rank of the "model" axis computes: its q heads, the kv
    heads it holds (``n_kv_heads`` when they are whole on every rank), its
    FFN width, its vocab block, its width of the shared experts (DeepSeek-
    V2's ``d_ff_expert * n_shared_experts``) and its Mamba2 heads
    (``ssm_expand * d_model / ssm_head_dim``; 0 where there are none)."""
    heads: int
    kv_heads: int
    ffn: int
    vocab: int
    shared_ffn: int = 0
    ssm_heads: int = 0


def tp_whole(cfg) -> TPLayout:
    """``cfg``'s layout on a single rank: every count whole."""
    ssm = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim \
        if cfg.family == "ssm_hybrid" else 0
    return TPLayout(cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
                    cfg.d_ff_expert * cfg.n_shared_experts, ssm)


def tp_layout(cfg, mesh) -> TPLayout:
    """``cfg``'s tensor-parallel layout on ``mesh`` (anything with
    ``axis_names`` and ``shape``), from the rules alone: heads, the FFN
    widths, the Mamba2 heads and the vocab are split where
    ``DEFAULT_RULES`` put them on "model" and the split falls on whole
    heads (``n_heads % m``; xLSTM's 4 heads stay whole on a 16-way axis,
    where ``repro`` cuts quarter heads); the kv heads where ``n_kv_heads %
    m`` (else each rank keeps them whole and reads the one its q heads
    use, which needs every rank's q heads inside one kv head, else it
    raises).  Whole everywhere for a mesh without a "model" extent."""
    whole = tp_whole(cfg)
    m = mesh.shape["model"] if "model" in mesh.axis_names else 1
    if m == 1 or cfg.family not in TP_FAMILIES:
        return whole

    def split(n, axis):
        ok = n and spec_pspec(P((n,), (axis,)), mesh) == \
            PartitionSpec("model")
        return n // m if ok else n
    heads, kv = cfg.n_heads, cfg.n_kv_heads
    if cfg.n_heads % m == 0 and split(cfg.n_heads * cfg.hd, "heads") < \
            cfg.n_heads * cfg.hd:
        heads = cfg.n_heads // m
        if cfg.n_kv_heads % m == 0:
            kv = cfg.n_kv_heads // m
        elif (cfg.n_heads // cfg.n_kv_heads) % heads:
            raise ValueError(
                f"{cfg.name}: {heads} q heads a rank straddle kv heads of "
                f"{cfg.n_heads // cfg.n_kv_heads} (model axis {m})")
    ssm = whole.ssm_heads
    if ssm % m == 0 and split(ssm * cfg.ssm_head_dim, "mlp") < \
            ssm * cfg.ssm_head_dim:
        ssm //= m
    return TPLayout(heads, kv, split(cfg.d_ff, "mlp"),
                    split(cfg.vocab, "vocab"),
                    split(whole.shared_ffn, "mlp"), ssm)


def _leaf_kind(name: str, table: dict):
    """``table``'s entry for the parameter ``name`` (its layer indices
    dropped), matched by suffix; None for none."""
    bare = ".".join(s for s in name.split(".") if not s.isdigit())
    return next((v for k, v in table.items()
                 if bare == k or bare.endswith("." + k)), None)


def _split_field(field: str, cfg, mesh) -> bool:
    return getattr(tp_layout(cfg, mesh), field) != \
        getattr(tp_whole(cfg), field)


def tp_block(name: str, spec, cfg, mesh) -> bool:
    """Whether the parameter ``name`` (placed by ``spec``) stays this
    rank's block over "model" in the compute tree (its consumer computes
    on the block), by ``tp_layout``; False for a leaf every model rank
    reads whole and for a re-blocked one (``tp_pieces``).  Raises where
    the layout splits a leaf its spec does not put on "model"."""
    table = _XLSTM_LEAVES if cfg.family == "xlstm" else _TP_LEAVES
    kind = _leaf_kind(name, table)
    if kind is None or not _split_field(kind[0], cfg, mesh):
        return False
    field, dim = kind
    part = spec[dim] if dim < len(spec) else None
    if part != "model":
        raise ValueError(f"{name}: the tensor-parallel layout splits its "
                         f"{field} over 'model', its spec is {spec}")
    return True


def tp_leaves(model, mesh) -> frozenset:
    """The names of ``model``'s parameters that ``tp_block`` keeps as
    blocks over "model" on ``mesh``."""
    return frozenset(name for name, sh in model_shardings(model, mesh)
                     .items() if tp_block(name, sh.spec, model.cfg, mesh))


def tp_piece(name: str, cfg, mesh, index: int):
    """(dimension, ((start, stop), ...)) of the re-blocked leaf ``name``
    that the rank at ``index`` on "model" computes on, the ranges
    concatenated in order; None where the leaf is no re-blocked one on
    ``mesh``: MLA's ``wuq``, its heads' columns; Mamba2's ``in_proj``, its
    heads' z, x and dt columns and the B / C columns whole (cut by the
    split sizes [di, di, n, n, h], never by ``repro``'s block)."""
    kind = _leaf_kind(name, _TP_PIECES)
    if kind is None or not _split_field(kind[0], cfg, mesh):
        return None
    lay = tp_layout(cfg, mesh)
    if kind[0] == "heads":
        w = cfg.qk_nope_dim + cfg.qk_rope_dim
        return 1, ((index * lay.heads * w, (index + 1) * lay.heads * w),)
    h, hl, n = tp_whole(cfg).ssm_heads, lay.ssm_heads, cfg.ssm_state
    di, dl = h * cfg.ssm_head_dim, hl * cfg.ssm_head_dim
    return 1, ((index * dl, (index + 1) * dl),
               (di + index * dl, di + (index + 1) * dl),
               (2 * di, 2 * di + 2 * n),
               (2 * di + 2 * n + index * hl, 2 * di + 2 * n + (index + 1)
                * hl))


def tp_pieces(model, mesh, index=None) -> dict:
    """{name: ``tp_piece``} of ``model``'s re-blocked parameters on
    ``mesh``, for the rank at ``index`` on "model" (this rank's,
    ``mesh.coords``, by default)."""
    if index is None:
        index = mesh.coords.get("model", 0)
    out = {}
    for name in model_shardings(model, mesh):
        piece = tp_piece(name, model.cfg, mesh, index)
        if piece is not None:
            out[name] = piece
    return out


def batch_pspec(mesh, batch: int, ndim: int) -> PartitionSpec:
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    if not axes or batch % mesh_extent(mesh, axes) != 0:
        # Try the data axis alone before giving up.
        axes = tuple(a for a in ("data",) if a in mesh.axis_names)
        if not axes or batch % mesh_extent(mesh, axes) != 0:
            return PartitionSpec(*([None] * ndim))
    return PartitionSpec(axes if len(axes) > 1 else axes[0],
                         *([None] * (ndim - 1)))


def input_shardings(mesh, batch_specs) -> dict:
    """Shardings for a train/prefill input tree: batch on ("pod","data")."""
    return tree_map(lambda s: NamedSharding(
        mesh, batch_pspec(mesh, s.shape[0], len(s.shape))), batch_specs)


# KV-cache leaves that carry kv-heads on axis -2.
_KV_KEYS = ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v",
            "dense_k", "dense_v", "img_k", "img_v")


def cache_shardings(mesh, cache_specs, batch: int):
    """Shardings for a decode cache tree (``repro``'s rule: the first
    axis of size ``batch`` on ("pod","data"), which may be another axis
    than the rows where one comes before them at the same size, e.g. the
    vlm's groups; kv heads (axis -2) of a KV cache, and the widest
    divisible trailing axis of an SSM / xLSTM state, on "model").  The
    port's steps hold these kv-head blocks (``runtime.steps.local_cache``:
    each rank its rows and, where the kv heads split, its kv heads of the
    self, image, cross and shared-block caches), MLA's ``ckv`` / ``kr``
    whole over "model" as here, and the recurrent state split by the
    heads its blocks compute on instead of this rule's axis."""
    model = mesh.shape.get("model", 1)
    dp = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    dp_size = mesh_extent(mesh, dp) if dp else 1

    def one(key, s):
        parts: list = [None] * len(s.shape)
        for i, d in enumerate(s.shape):
            if d == batch and dp and batch % dp_size == 0:
                parts[i] = dp if len(dp) > 1 else dp[0]
                break
        if key in _KV_KEYS and len(s.shape) >= 4 \
                and s.shape[-2] % model == 0 and model > 1:
            parts[-2] = "model"
        elif key in ("S", "C", "conv") and len(s.shape) >= 4 and model > 1:
            # ssm state [.., B, H, N, P] / conv [.., B, K-1, C] — shard the
            # widest trailing axis divisible by model.
            for i in range(len(s.shape) - 1, 1, -1):
                if parts[i] is None and s.shape[i] % model == 0 \
                        and s.shape[i] >= model:
                    parts[i] = "model"
                    break
        return NamedSharding(mesh, PartitionSpec(*parts))

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return one(key, tree)

    return walk(cache_specs, None)


# ------------------------------------------------------------ placement
def shard_slices(shape, spec, mesh) -> tuple:
    """This rank's block of a ``shape`` array under ``spec``: one slice
    per dimension (a dimension over several axes splits row-major in the
    spec's order, as jax's ``devices_indices_map``)."""
    out = []
    for i, dim in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        if part is None:
            out.append(slice(None))
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        n, pos = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            pos = pos * mesh.shape[a] + mesh.coords[a]
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split {n} ways ({spec})")
        out.append(slice(pos * (dim // n), (pos + 1) * (dim // n)))
    return tuple(out)


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` (a view)."""
    return x[shard_slices(x.shape, spec, mesh)]


def _spec_axes(part) -> tuple:
    return () if part is None else (part,) if isinstance(part, str) \
        else tuple(part)


def gather_full(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full tensor of which ``x`` is this rank's block (every rank of
    the mesh must call it)."""
    for dim, part in enumerate(sharding.spec):
        if part is not None:
            x = sharding.mesh.all_gather(x, _spec_axes(part), dim)
    return x


def _zip_map(fn, tree, shardings):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, f),
                                     getattr(shardings, f))
                            for f in tree._fields))
    return fn(tree, shardings)


def shard_params(tree, shardings):
    """Each leaf's block on this rank (a contiguous copy), for a tree (a
    dict, possibly nested, or an ``OptState``) and the matching tree of
    ``NamedSharding``."""
    return _zip_map(lambda x, sh: local_shard(x, sh.spec, sh.mesh)
                    .contiguous().clone(), tree, shardings)


def gather_params(tree, shardings):
    """The full leaves of a tree of blocks (collective: every rank calls
    it, in one order)."""
    return _zip_map(gather_full, tree, shardings)


@torch.no_grad()
def init_sharded(model, shardings: dict, generator: torch.Generator,
                 device) -> dict:
    """{parameter name: this rank's block} of ``model``'s random weights:
    each leaf of ``model.specs`` drawn whole from ``generator`` in leaf
    order (the draws ``init_params_into`` makes, so every rank holds
    blocks of the same weights), split per layer, cut to the block and
    cast to the parameter's dtype (``model`` may live on the meta device),
    the whole leaf freed before the next is drawn."""
    params = dict(model.named_parameters())
    out = {}
    for name, spec in flatten(model.specs).items():
        t = _init_one(spec, generator, device)
        for pname, part in _per_layer(name, t, model):
            sh = shardings[pname]
            out[pname] = local_shard(part, sh.spec, sh.mesh).to(
                params[pname].dtype).clone()
        del t
    return out


def batch_axes(mesh, batch: int) -> tuple:
    """The mesh axes ``batch_pspec`` splits a batch of ``batch`` rows on
    (() when it is replicated)."""
    return _spec_axes(batch_pspec(mesh, batch, 1)[0])


def split_batch(mesh, batch: dict):
    """(a view of ``mesh`` naming the batch axes, this rank's rows of
    every leaf of ``batch``): the rows ``batch_pspec`` gives this rank."""
    b = next(iter(batch.values())).shape[0]
    axes = batch_axes(mesh, b)
    spec = PartitionSpec(axes if len(axes) > 1 else axes[0]) if axes \
        else PartitionSpec()
    return mesh.with_batch(axes), {k: local_shard(v, spec, mesh)
                                   for k, v in batch.items()}


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """All ranks' rows of ``x`` (split on ``mesh.batch_axes``), in batch
    order."""
    return mesh.all_gather(x, mesh.batch_axes, 0) if mesh.batch_axes else x


def mesh_of(shardings) -> Optional[object]:
    """The mesh of the first ``NamedSharding`` in a tree (None for none)."""
    if shardings is None:
        return None
    if isinstance(shardings, NamedSharding):
        return shardings.mesh
    vals = shardings.values() if isinstance(shardings, dict) \
        else list(shardings)
    for v in vals:
        m = mesh_of(v)
        if m is not None:
            return m
    return None
