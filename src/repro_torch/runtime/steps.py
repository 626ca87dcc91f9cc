"""Train / serve step builders (port of src/repro/runtime/steps.py).

The port's model holds its parameters, so the loss and the serving steps
take none, and the train step updates the model's parameters in place:

  * ``loss_fn(batch) -> (loss, metrics)`` (``make_loss_fn``);
  * ``train_step(params, opt, batch) -> (params, opt, metrics)``
    (``make_train_step``): ``params`` is ``dict(model.named_parameters())``,
    updated in place with ``opt``'s moments and returned, as ``repro``'s
    pure step returns new ones; gradient accumulation over
    ``run.microbatch`` microbatches, z-loss and the MoE load-balance loss;
    ``metrics`` holds ``loss``, ``ce`` (and ``lb_loss`` / ``dropped``
    when the model reports them), ``grad_norm`` and ``lr``, 0-d tensors on
    the device (nothing waits for the card);
  * ``prefill_step(batch) -> last logits [B, V]`` and
    ``serve_step(tokens [B, 1], cache) -> (next tokens [B, 1] i32,
    cache)``, both under ``torch.inference_mode()``.

With a mesh (``launch.mesh.Mesh``) the steps are ``repro``'s under
GSPMD, run on this rank.  The model is a template (build it on the
"meta" device: it holds no weights) and every step takes the rank's
parameter blocks first, as ``repro``'s steps take params:

  * ``train_step(params, opt, batch)``: ``params`` and ``opt``'s moments
    are this rank's blocks ({name: tensor} placed by
    ``sharding.rules.model_shardings``; ``init_sharded`` or
    ``shard_params`` make them), updated in place; ``batch`` is the
    global batch (every rank holds it; each takes its rows,
    ``split_batch``);
  * ``prefill_step(params, batch) -> [B, V]`` and ``serve_step(params,
    tokens [B, 1], cache) -> (next tokens [B, 1], cache)``: the global
    batch in and out (the rows gathered back), the cache this rank's
    rows and kv heads (``local_cache``); ``params`` may also be
    ``compute_params``'s tree, gathered once for many steps.

The forward reads the compute tree: ``cast_params`` (every >= 2-D f32
block cast to bf16, as ``repro`` casts before GSPMD's gathers, so the
f32 unembedding reads bf16-rounded weights with a mesh and f32 ones
without), then each block all-gathered over the axes it is split on
(``launch.mesh.gather_fwd``; ``_leaf``'s rule), except the expert
weights, which
``moe_ffn`` takes as they are placed, and the tensor-parallel leaves of
every family (``sharding.rules.tp_block``: the attention's q / k / v / o
weights and biases, self, cross, MLA's ``wuk`` / ``wuv`` / ``wo`` and
zamba2's shared block's, where the "model" split falls on whole heads,
the FFN's and the shared experts', Mamba2's ``out_proj``, the xLSTM
blocks' head columns and rows, the embedding table and the unembedding
where the vocab is split), which are gathered over the batch axes only
and keep their "model" block: the model computes on them (Megatron's
column / row layout, ``models.attention`` / ``models.ffn`` /
``models.ssm`` / ``models.xlstm`` / ``models.layers``), the residual
stream whole over "model" between sublayers.  A re-blocked leaf (MLA's
``wuq``, Mamba2's ``in_proj``: ``sharding.rules.tp_pieces``) is gathered
whole and cut to the piece this rank computes on; its gradient is
reduce-scattered over "model", each rank's covering only its piece.  A
whole leaf the model reads only in part (Mamba2's conv, ``a_log``,
``d_skip``, ``dt_bias``, the split norms' scales, the mLSTM's ``wi`` /
``wf``, the sLSTM's ``r*`` and ``wo``) is cut in the model, through
``psum_bwd`` (``layers.model_part``).  A step handed the rank's blocks
gathers that tree a stacked block at a time (``PerBlock``), as GSPMD
gathers each layer inside ``repro``'s scan: the leaves outside the
stacks are gathered once a step and put in place of the template's
parameters (taken out after the backward), and each block's leaves
just before it runs, freed after it; a remat block's backward gathers
them again when it recomputes (collectives included, on every rank
alike), and a block that is not rematerialized gathers a saved leaf
again when its backward reads it.  No step falls back to the whole
tree.  Gradients land on each parameter's own block
(``repro``'s ``constrain_grads``), by the collectives' backward: summed
over the axes the batch is split on (each rank's loss is its share of
the global one: ``cross_entropy`` averages over the batch axes with
``psum_fwd``), taken as this rank's slice over the axes every rank
computes alike ("model" for a leaf read whole), and a block's own over
"model" for a tensor-parallel leaf.  With a vocab split the logits are
this rank's block [B, S, V / m]: ``cross_entropy`` is vocab-parallel,
and the prefill and serve steps gather the last logits over "model"
before the rows.  The cache holds this rank's rows and, where the
layout splits them, its kv heads and the heads of its recurrent state
(``local_cache``: the vlm's image caches, the encdec's cross caches,
zamba2's shared-block caches too; MLA's ``ckv`` / ``kr`` whole).  The
vlm's image and the encdec's frames are split by rows like the tokens;
the image enters the cross-attention's k / v, the encoder's output each
decoder layer's, through ``psum_bwd``.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import gather_fwd, psum_bwd, psum_fwd
from repro_torch.models.layers import model_block
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.sharding.rules import batch_axes, cache_shardings, \
    gather_rows, mesh_extent, model_shardings, split_batch, tp_layout, \
    tp_leaves, tp_pieces, tp_whole

# The expert weights: ``moe_ffn`` gathers them over "data" itself and
# keeps their "model" blocks local.
_EXPERT_LEAVES = ("moe.w_gate", "moe.w_up", "moe.w_down")


class ComputeParams(dict):
    """{parameter name: the tensor the forward reads} (``compute_params``)."""


def cast_params(params: dict) -> dict:
    """``repro``'s compute cast under a mesh: every >= 2-D f32 leaf to
    bf16 (norm scales and biases stay f32)."""
    return {k: p.to(torch.bfloat16) if p.dtype == torch.float32
            and p.dim() >= 2 else p for k, p in params.items()}


def _leaf(name: str, x, sh, axes: tuple, keep, pieces: dict):
    """One leaf of the compute tree: ``x`` (this rank's block of
    ``name``, placed by ``sh``) gathered over the axes it is split on, the
    gradient summed over those of ``axes`` (the batch's) and sliced over
    the others; a block whole along a batch axis sums its gradient over it
    (``psum_bwd``).  The expert weights stay as placed; a leaf named in
    ``keep`` (``sharding.rules.tp_leaves``) keeps its "model" block; a
    re-blocked leaf (``pieces``: ``sharding.rules.tp_pieces``) is
    gathered whole, its gradient reduce-scattered over "model" too (each
    rank's covers only its piece), and cut to this rank's piece."""
    split = set()
    for dim, part in enumerate(sh.spec):
        if part is None:
            continue
        parts = (part,) if isinstance(part, str) else tuple(part)
        split.update(parts)
        if name.endswith(_EXPERT_LEAVES):
            continue
        if name in keep and "model" in parts:
            if len(parts) > 1:
                raise ValueError(f"{name}: 'model' shares dimension "
                                 f"{dim} with {parts}")
            continue
        red = {a in axes or (name in pieces and a == "model")
               for a in parts}
        if len(red) > 1:
            raise ValueError(f"{name}: {parts} mixes batch and other "
                             f"axes")
        x = gather_fwd(x, sh.mesh, parts, dim, reduce=red.pop())
    rest = tuple(a for a in axes if a not in split)
    if rest:
        x = psum_bwd(x, sh.mesh, rest)
    if name in pieces:
        dim, ranges = pieces[name]
        x = torch.cat([x.narrow(dim, a, b - a) for a, b in ranges], dim)
    return x


def _compute_tree(params: dict, shardings: dict, axes: tuple,
                  keep=frozenset(), pieces=None) -> ComputeParams:
    """Every leaf of ``params`` gathered at once by ``_leaf``'s rule."""
    pieces = pieces or {}
    return ComputeParams((name, _leaf(name, x, shardings[name], axes, keep,
                                      pieces))
                         for name, x in params.items())


def block_leaves(model: Model) -> dict:
    """{id of a stacked block (``Model.stacked_blocks``): [(leaf name in
    the block, parameter name)]}."""
    return {id(block): [(rel, f"{pre}.{rel}")
                        for rel, _ in block.named_parameters()]
            for pre, block in model.stacked_blocks().items()}


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


class _Regather(NamedTuple):
    """A saved gathered leaf, kept as its name and its view's geometry."""
    name: str
    size: torch.Size
    stride: tuple
    offset: int


class PerBlock:
    """One mesh step's gathers of its stacked blocks, a block at a time.

    ``step_tree()`` is the compute tree of the leaves outside the stacks
    (the embedding, the unembedding, the final norms, zamba2's ``shared``
    block), gathered once a step.  Called on a block (``Model._take``,
    inside the function ``_wrap_remat`` wraps), it returns that block's
    compute leaves (nested as the block's ``ParamTree``), each by
    ``_leaf``'s rule (cast first to train, as ``cast_params`` casts); a
    rematerialized block's backward calls it again.  Under ``hooks()`` a
    gathered leaf that autograd saves for the backward of a block that is
    not rematerialized (remat "none"; the vlm's cross blocks, zamba2's
    LoRA, the sLSTM) is saved as its name and gathered again when the
    backward reads it, so no block's gathered copy waits for the
    backward."""

    def __init__(self, blocks: dict, params: dict, shardings: dict,
                 axes: tuple, keep, pieces: dict, cast: bool):
        self.blocks, self.params, self.shardings = blocks, params, shardings
        self.axes, self.keep, self.pieces = axes, keep, pieces
        self.cast = cast
        self._held = {}

    def leaf(self, name: str) -> torch.Tensor:
        x = self.params[name]
        if self.cast:
            x = cast_params({name: x})[name]
        return _leaf(name, x, self.shardings[name], self.axes, self.keep,
                     self.pieces)

    def step_tree(self) -> ComputeParams:
        inside = {n for leaves in self.blocks.values() for _, n in leaves}
        return ComputeParams((n, self.leaf(n)) for n in self.params
                             if n not in inside)

    def __call__(self, block) -> dict:
        out = {}
        for rel, name in self.blocks[id(block)]:
            t = self.leaf(name)
            root = _root(t)
            if root.untyped_storage()._cdata != \
                    self.params[name].untyped_storage()._cdata:
                self._held[id(root)] = (weakref.ref(root), name)
            node = out
            *path, last = rel.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = t
        return out

    def _pack(self, t):
        root = _root(t)
        hit = self._held.get(id(root))
        if hit is None or hit[0]() is not root:
            return t
        return _Regather(hit[1], t.size(), t.stride(), t.storage_offset())

    def _unpack(self, saved):
        if not isinstance(saved, _Regather):
            return saved
        with torch.no_grad():
            t = self.leaf(saved.name)
        return t.as_strided(saved.size, saved.stride, saved.offset)

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)


def compute_params(model: Model, params: dict, mesh) -> ComputeParams:
    """The serving steps' compute tree of this rank's blocks (no cast, as
    ``repro``'s prefill and serve steps do none), every leaf at once:
    gather it once and hand it to many steps."""
    return _compute_tree(params, model_shardings(model, mesh), (),
                         tp_leaves(model, mesh), tp_pieces(model, mesh))


def _bind(model: Model, tree: dict, per_block=None) -> None:
    """Put ``tree``'s tensors in place of the model's parameters (the
    originals kept until ``_release``) and ``per_block`` (a ``PerBlock``)
    in the model's reach: ``Model._take`` calls it on each block."""
    saved = model.__dict__.setdefault("_unbound", {})
    for name, t in tree.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        saved.setdefault(name, mod._parameters[leaf])
        mod._parameters[leaf] = t
    if per_block is not None:
        model.__dict__["_per_block"] = per_block


def _release(model: Model) -> None:
    model.__dict__.pop("_per_block", None)
    for name, p in model.__dict__.pop("_unbound", {}).items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = p


@contextlib.contextmanager
def bound(model: Model, tree: dict, per_block=None):
    """``model`` reading ``tree`` in place of its parameters (and its
    stacked blocks through ``per_block``, where given)."""
    _bind(model, tree, per_block)
    try:
        yield model
    finally:
        _release(model)


# The cache leaves whose kv heads (axis -2) follow the attention's.
_KV_CACHE = ("k", "v", "dense_k", "dense_v", "img_k", "img_v", "cross_k",
             "cross_v", "attn_k", "attn_v")
# The recurrent state leaves, split by the heads their block computes on.
_STATE_CACHE = ("S", "C", "n", "m", "c", "h", "conv")


def local_cache(model: Model, mesh, batch: int, max_len: int, device):
    """``model.init_cache`` for this rank's rows of a ``batch``-row decode
    under ``mesh`` (``mesh`` needs only ``axis_names`` and ``shape``), and
    where ``tp_layout`` splits them over "model": the kv heads of every
    leaf in ``_KV_CACHE`` (the blocks the attention's k / v weights give,
    where ``sharding.rules.cache_shardings`` puts them on "model" too),
    and the heads of every recurrent state leaf (Mamba2's ``S`` [.., B,
    H / m, N, P] and ``conv`` [.., B, K-1, di / m + 2 N], its B / C
    channels whole; the mLSTM's ``C`` / ``n`` / ``m`` and the sLSTM's
    ``c`` / ``n`` / ``h`` / ``m`` at H / m heads).  That state block is
    the one the blocks compute on, not ``cache_shardings``' (the widest
    divisible trailing axis: ``S``'s P, ``C``'s dv, ``conv``'s contiguous
    channels), a difference pinned by design (ROADMAP §3): ``S`` and
    ``C`` hold as many bytes a rank.  MLA's ``ckv`` / ``kr`` stay whole
    over "model"; so does everything on a mesh that splits nothing."""
    n = mesh_extent(mesh, batch_axes(mesh, batch))
    cfg = model.cfg
    lay, whole = tp_layout(cfg, mesh), tp_whole(cfg)
    kw = {}
    if lay.kv_heads != whole.kv_heads and cfg.family != "xlstm":
        kw["kv_heads"] = lay.kv_heads
    heads = {"ssm_hybrid": "ssm_heads", "xlstm": "heads"}.get(cfg.family)
    if heads and getattr(lay, heads) != getattr(whole, heads):
        kw["heads"] = getattr(lay, heads)
    if not kw:
        return model.init_cache(batch // n, max_len, device=device)
    specs = cache_shardings(mesh, model.cache_specs(batch, max_len), batch)
    if "kv_heads" in kw:
        for key in _KV_CACHE:
            if key in specs and specs[key].spec[-2] != "model":
                raise ValueError(f"{key}: the attention splits its "
                                 f"{lay.kv_heads} kv heads, cache_shardings "
                                 f"gives {specs[key].spec}")
    cache = model.init_cache(batch // n, max_len, device=device, **kw)
    rows = model.cache_specs(batch // n, max_len)
    m = mesh.shape["model"]
    for path, t in _leaves(cache):
        if path[-1] not in _STATE_CACHE:
            continue
        want = _leaf_at(rows, path)
        cut = [i for i, (a, b) in enumerate(zip(t.shape, want.shape))
               if a != b]
        ok = len(cut) == 1 and (want.shape[cut[0]] % m == 0 and t.shape[
            cut[0]] * m == want.shape[cut[0]] or path[-1] == "conv")
        if not ok:
            raise ValueError(f"{'/'.join(path)}: a state block of "
                             f"{tuple(t.shape)} from {tuple(want.shape)} "
                             f"on a {m}-way 'model' axis")
    return cache


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), v


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def cross_entropy(logits, labels, z_loss_coef: float, mesh=None,
                  vocab=None):
    """Token-mean CE over f32 logits [..., V]; returns (ce + z-loss, ce).

    ``repro`` takes the gold logit as a masked sum over the one-hot of
    the label (it partitions over a sharded vocab); here it is a
    ``gather``, the same value without a second [B, S, V] f32 tensor.
    With a mesh (a view naming the batch axes) the logits are this
    rank's rows: the means are the global batch's (``psum_fwd`` over the
    batch axes), and their gradient on each rank its share.  Where they
    are also this rank's block of ``vocab`` over "model", the CE is
    vocab-parallel: the shift is the ``pmax`` of the local maxima
    (detached), the sum of exponentials and the gold logit (a masked
    local gather) are summed over "model" with ``psum_fwd``, and the
    z-loss reads the global lse.
    """
    if vocab is not None and model_block(mesh, logits.shape[-1], vocab):
        lse, gold = _vocab_parallel(logits, labels, mesh)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    axes = tuple(mesh.batch_axes) if mesh is not None else ()
    n = mesh_extent(mesh, axes) if axes else 1

    def mean(t):
        t = torch.mean(t)
        return psum_fwd(t, mesh, axes) / n if axes else t
    ce = mean(lse - gold)
    zl = z_loss_coef * mean(torch.square(lse)) if z_loss_coef else 0.0
    return ce + zl, ce


def _vocab_parallel(logits, labels, mesh):
    """(lse, gold logit) of a vocab block of the logits over "model"."""
    n = logits.shape[-1]
    shift = mesh.pmax(logits.detach().amax(dim=-1), "model")
    total = psum_fwd(torch.exp(logits - shift[..., None]).sum(dim=-1), mesh,
                     "model")
    lse = shift + torch.log(total)
    idx = labels.long() - mesh.index("model") * n
    mine = (idx >= 0) & (idx < n)
    gold = torch.gather(logits, -1, torch.where(mine, idx, 0)[..., None])
    gold = psum_fwd(gold[..., 0].masked_fill(~mine, 0), mesh, "model")
    return lse, gold


def make_loss_fn(model: Model, run: RunConfig, mesh=None):
    """``loss_fn(batch) -> (loss, metrics)``; with a mesh,
    ``loss_fn(params, batch)``: this rank's blocks and the global batch,
    the forward on ``cast_params``' compute tree (see the module doc),
    which stays bound to the model (its backward recomputes remat blocks
    from it) until the caller's ``_release(model)``."""
    cfg = model.cfg

    def forward_loss(batch, view):
        logits, aux = model(run, batch, mesh=view)
        loss, ce = cross_entropy(logits, batch["labels"], run.z_loss, view,
                                 cfg.vocab)
        metrics = {"ce": ce}
        if "lb_loss" in aux:
            loss = loss + cfg.router_aux_coef * aux["lb_loss"]
            metrics["lb_loss"] = aux["lb_loss"]
            metrics["dropped"] = aux["dropped"].float()
        metrics["loss"] = loss
        return loss, metrics

    if mesh is None:
        return lambda batch: forward_loss(batch, None)
    shardings = model_shardings(model, mesh)
    keep, pieces = tp_leaves(model, mesh), tp_pieces(model, mesh)
    blocks = block_leaves(model)

    def loss_fn(params, batch):
        view, rows = split_batch(mesh, batch)
        per = PerBlock(blocks, params, shardings, view.batch_axes, keep,
                       pieces, cast=True)
        _bind(model, per.step_tree(), per)
        with per.hooks():
            return forward_loss(rows, view)

    loss_fn.shardings = shardings
    return loss_fn


def make_grad_fn(model: Model, run: RunConfig, mesh=None):
    """``grad_fn(params, batch) -> (grads, metrics)``: the gradients of
    the loss with respect to ``params`` ({name: parameter}, or this
    rank's blocks under a mesh: their gradients are the blocks of the
    global loss's), f32 sums of ``g / nmb`` over ``run.microbatch``
    microbatches of the global batch when it is above 1 (``repro``'s
    scan, in its order; each microbatch split over the batch axes), and
    the metrics (detached) averaged the same way.  ``make_train_step``'s
    gradient half."""
    loss_fn = make_loss_fn(model, run, mesh)

    def one(params, batch):
        if mesh is None:
            loss, metrics = loss_fn(batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        else:
            try:
                loss, metrics = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, list(params.values()))
            finally:
                _release(model)
        return (dict(zip(params, grads)),
                {k: m.detach() for k, m in metrics.items()})

    def grad_fn(params, batch):
        nmb = run.microbatch
        if not nmb or nmb <= 1:
            return one(params, batch)

        def split(x):
            return x.reshape((nmb, x.shape[0] // nmb) + x.shape[1:])
        mb_batch = {k: split(x) for k, x in batch.items()}
        gacc = {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for k, p in params.items()}
        dev = next(iter(params.values())).device
        names = ["ce", "loss"] + (["lb_loss", "dropped"]
                                  if model.cfg.n_experts else [])
        macc = {k: torch.zeros((), dtype=torch.float32, device=dev)
                for k in names}
        for i in range(nmb):
            grads, metrics = one(params, {k: x[i]
                                          for k, x in mb_batch.items()})
            gacc = {k: a + grads[k].float() / nmb for k, a in gacc.items()}
            macc = {k: a + metrics[k] / nmb for k, a in macc.items()}
        return gacc, macc

    grad_fn.shardings = getattr(loss_fn, "shardings", None)
    return grad_fn


def make_train_step(model: Model, run: RunConfig, mesh=None):
    grad_fn = make_grad_fn(model, run, mesh)

    def train_step(params, opt: adamw.OptState, batch):
        grads, metrics = grad_fn(params, batch)
        lr = adamw.schedule(run, opt.step)
        params, opt, gnorm = adamw.update(grads, opt, params, run, lr,
                                          grad_fn.shardings)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt, metrics

    return train_step


def _serving(model, shardings, keep, pieces):
    """``trees(params) -> (the tree to bind, the PerBlock or None)`` of
    the serving steps: a ``ComputeParams`` tree bound as it is, this
    rank's blocks gathered block by block (uncast)."""
    blocks = block_leaves(model)

    def trees(params):
        if isinstance(params, ComputeParams):
            return params, None
        per = PerBlock(blocks, params, shardings, (), keep, pieces,
                       cast=False)
        return per.step_tree(), per
    return trees


def _last_row(model: Model, view, logits):
    """This rank's rows of the last position's logits [B_loc, V],
    gathered over "model" along the vocab where they are its block."""
    last = logits[:, -1, :]
    if model_block(view, last.shape[-1], model.cfg.vocab):
        last = view.all_gather(last, "model", 1)
    return last


def make_prefill_step(model: Model, run: RunConfig, mesh=None):
    """Forward-only step over a full sequence (the inference-prefill cell):
    ``prefill_step(batch)``, or ``prefill_step(params, batch)`` under a
    mesh (see the module doc)."""

    if mesh is None:
        @torch.inference_mode()
        def prefill_step(batch):
            logits, _ = model.forward(run, batch)
            # Next-token logits for the last position only.
            return logits[:, -1, :]

        return prefill_step
    trees = _serving(model, model_shardings(model, mesh),
                     tp_leaves(model, mesh), tp_pieces(model, mesh))

    @torch.inference_mode()
    def prefill_mesh(params, batch):
        view, rows = split_batch(mesh, batch)
        with bound(model, *trees(params)):
            logits, _ = model.forward(run, rows, mesh=view)
        return gather_rows(view, _last_row(model, view, logits))

    return prefill_mesh


def make_serve_step(model: Model, run: RunConfig, mesh=None):
    """One greedy decode step against a KV cache: ``serve_step(tokens,
    cache)``, or ``serve_step(params, tokens, cache)`` under a mesh (see
    the module doc)."""

    if mesh is None:
        @torch.inference_mode()
        def serve_step(tokens, cache):
            logits, cache = model.decode_step(run, tokens, cache)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            return nxt[:, None], cache

        return serve_step
    trees = _serving(model, model_shardings(model, mesh),
                     tp_leaves(model, mesh), tp_pieces(model, mesh))

    @torch.inference_mode()
    def serve_mesh(params, tokens, cache):
        view, rows = split_batch(mesh, {"tokens": tokens})
        with bound(model, *trees(params)):
            logits, cache = model.decode_step(run, rows["tokens"], cache,
                                              mesh=view)
        # The greedy token of the whole row: the first index on ties.
        nxt = torch.argmax(_last_row(model, view, logits), dim=-1)
        return gather_rows(view, nxt.to(torch.int32))[:, None], cache

    return serve_mesh
