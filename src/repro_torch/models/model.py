"""Model assembly (port of src/repro/models/model.py: the dense, MoE,
vlm, encdec, ssm_hybrid and xlstm families).

``repro``'s ``Model`` is a record of pure functions over a param tree; the
port's is an ``nn.Module`` that holds its parameters (one ``ParamTree``
per layer of each stack in an ``nn.ModuleList``, named after ``repro``'s
tree: ``blocks.{i}.attn.wq.w``, ``dense_blocks.{i}.ffn.w_up.w``,
``embed.table``, ``unembed.w``; a nested stack is a ModuleList of
groups: the vlm's ``groups.{g}.selfs.{j}.attn.wq.w`` and
``groups.{g}.cross.gate``, zamba2's ``groups.{g}.mambas.{j}.in_proj.w``
and ``groups.{g}.lora.a_q`` beside one ``shared.*`` block and a
``tail.{j}.*`` stack, xLSTM's ``groups.{g}.mlstms.{j}.wq.w`` and
``groups.{g}.slstm.rz``) on an explicit device, and whose methods drop
the params argument:

  * ``forward(run, batch, mesh=None) -> (logits [B, S, V] f32, aux)`` —
    the training and teacher-forced path, differentiable; ``run.remat``
    wraps each block in ``torch.utils.checkpoint`` as ``repro``'s
    ``_wrap_remat`` wraps it in ``jax.checkpoint`` (when grad is
    enabled);
  * ``init_cache(batch, max_len) -> cache`` (zeros);
  * ``decode_step(run, tokens [B, 1], cache, mesh=None) -> (logits
    [B, 1, V], cache)`` — the caches are written in place, one slot per
    layer;
  * ``prefill(run, tokens [B, S], max_len) -> (last logits [B, 1, V],
    cache)`` — the dense family's serving entry point.  The other
    families have none, as in ``repro``: their serving feeds the prompt
    through ``decode_step`` (``launch.serve``).

The last three run under ``torch.inference_mode()``.  ``mesh`` (a
``launch.mesh.Mesh`` view naming the batch axes) reaches the MoE layers,
as in ``repro``; with it the batch is this rank's rows and the MoE
family's ``aux`` the whole batch's (``runtime.steps`` under a mesh).  In
every family it also reaches the embedding, the attention (self, cross,
MLA, zamba2's shared block), the FFN and shared experts, the Mamba2 and
xLSTM blocks and the head, which compute on this rank's blocks over
"model" where the bound parameters are blocks
(``sharding.rules.tp_layout``): then the logits are this rank's vocab
block [B, S, V / m] (whole where the vocab does not split, as
SeamlessM4T's 256,206) and the cache holds this rank's kv heads
(``init_cache(kv_heads=)``: the vlm's image caches, the encdec's cross
caches, zamba2's shared-block caches too) and the heads of its
recurrent state (``init_cache(heads=)``).  Every loop reads a stacked
block through ``_take``, inside the function ``_wrap_remat`` wraps: a
mesh step handed the rank's blocks gathers the block's leaves there
(``runtime.steps.PerBlock``), so a rematerialized block gathers them
again when its backward recomputes.  ``cache_specs`` /
``abstract_params`` are meta-device stand-ins (shapes, no memory), and
``input_specs`` those of a cell's inputs.  Two builds:

  * serving (``trainable=False``, the default): each block leaf is
    stored in the dtype of its use (``_block_dtype``): bf16 for a leaf
    ``repro`` only ever casts to the activation dtype (dense weights and
    biases, the 3-D expert weights) — the same bits as ``repro``'s
    per-call cast, once at load; f32 for a leaf ``repro`` reads in f32
    (norm scales, the router, MLA's ``wuk`` / ``wuv``, which decode reads
    in f32: also the SSM's ``conv_w`` / ``conv_b`` / ``a_log`` /
    ``d_skip`` / ``dt_bias``, zamba2's LoRA ``a_q`` / ``b_q`` and the
    sLSTM's recurrent ``r*``, each cast per call as ``repro`` casts it);
    the embedding table and the unembedding stay f32; no parameter has a
    gradient;
  * training (``trainable=True``): every leaf in its spec's dtype (f32
    master weights, as ``repro``'s params are), with a gradient; ``dense``
    casts to bf16 on each call, as ``repro`` does.

Self-attention (zamba2's shared block's too) goes through the flash
kernel where its shape allows (``attention.self_attn``), where ``repro``
calls ``blockwise_attn``; under autograd through
``make_flash_attn_trainable``.  The SSM, mLSTM and sLSTM blocks launch
none of the port's kernels (``repro`` has no Pallas kernel for them).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import psum_bwd
from repro_torch.models import ssm, xlstm
from repro_torch.models import transformer as tf
from repro_torch.models.attention import cross_attn, cross_decode_attn, \
    cross_kv, gqa_decode_self_attn, gqa_project_qkv, gqa_self_attn, \
    gqa_spec, repeat_kv, self_attn
from repro_torch.models.ffn import ffn, ffn_spec
from repro_torch.models.layers import ACT_DTYPE, dense, embed, embed_spec, \
    model_block, rmsnorm, rmsnorm_spec, rope_tables, seq_block, \
    seq_parallel, seq_whole, unembed, unembed_spec
from repro_torch.models.module import ParamTree, abstract_params, \
    param_count, stack

CACHE_DTYPE = tf.CACHE_DTYPE


def _head_specs(cfg):
    s = {"embed": embed_spec(cfg.vocab, cfg.d_model),
         "final_norm": rmsnorm_spec(cfg.d_model)}
    if not cfg.tie_embeddings:
        s["unembed"] = unembed_spec(cfg.vocab, cfg.d_model)
    return s


# Block leaves that ``repro`` reads in f32 (the router's logits; MLA
# decode's absorbed products), kept f32 in the serving build.
_F32_READS = ("router.w", "attn.wuk.w", "attn.wuv.w")
# Block leaves that ``repro`` only casts to the activation dtype: dense
# weights and biases, and the experts' 3-D weights.
_ACT_LEAVES = ("w", "b", "w_gate", "w_up", "w_down")


def _block_dtype(name: str, spec):
    """A serving block leaf's dtype, by its use (see the module doc)."""
    if name.endswith(_F32_READS):
        return torch.float32
    return ACT_DTYPE if name.rsplit(".", 1)[-1] in _ACT_LEAVES else spec.dtype


def _positions(s, device):
    return torch.arange(s, dtype=torch.int32, device=device)


# The products "dots" keeps (``jax.checkpoint_policies.checkpoint_dots``):
# the aten ops a matmul or einsum decomposes into.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _wrap_remat(fn, run):
    """``fn`` under ``run.remat`` (``repro``'s ``_wrap_remat``): "none" as
    it is; "dots" keeps the matrix products and recomputes the rest;
    anything else ("full") recomputes the whole block in the backward.  Non-reentrant
    ``torch.utils.checkpoint``, and only while grad is enabled (without
    it nothing is saved to recompute)."""
    if run.remat == "none" or not torch.is_grad_enabled():
        return fn
    if run.remat == "dots":
        ctx = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint.checkpoint, fn,
                                 use_reentrant=False, context_fn=ctx)
    return functools.partial(checkpoint.checkpoint, fn, use_reentrant=False)


class Model(nn.Module):
    """Base of the port's models: the config, the spec tree in
    ``repro``'s layout (stacked blocks) and the head parameters."""

    def __init__(self, cfg: ModelConfig, specs: dict, device,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.specs = specs
        self.trainable = trainable
        head = functools.partial(ParamTree, device=device,
                                 requires_grad=trainable)
        self.embed = head(specs["embed"])
        self.final_norm = head(specs["final_norm"])
        if "unembed" in specs:
            self.unembed = head(specs["unembed"])
        if "enc_norm" in specs:
            self.enc_norm = head(specs["enc_norm"])

    def _block(self, block_spec: dict, device) -> ParamTree:
        """One block's ``ParamTree`` (serving dtypes by use, or f32 with a
        gradient when trainable)."""
        return ParamTree(block_spec, device,
                         None if self.trainable else _block_dtype,
                         requires_grad=self.trainable)

    def _stack(self, block_spec: dict, n: int, device) -> nn.ModuleList:
        """One ``ParamTree`` per layer of a stack of ``n`` blocks."""
        return nn.ModuleList(self._block(block_spec, device)
                             for _ in range(n))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def param_count(self) -> int:
        return param_count(self.specs)

    def stacked_blocks(self) -> dict:
        """{name: ParamTree} of every block of the stacks, in the order
        they were built (``blocks.3``, ``groups.1.selfs.0``,
        ``groups.1.cross``, ``groups.0.lora``, ``tail.2``); the head's
        leaves and zamba2's ``shared`` block are in none."""
        return {name: mod for name, mod in self.named_modules()
                if isinstance(mod, ParamTree) and "." in name
                and not isinstance(self.get_submodule(
                    name.rpartition(".")[0]), ParamTree)}

    def _take(self, p):
        """The leaves the stacked block ``p`` computes on: gathered for
        this call where a mesh step gathers block by block
        (``runtime.steps.PerBlock``), else ``p`` itself."""
        per_block = self.__dict__.get("_per_block")
        return p if per_block is None else per_block(p)

    def abstract_params(self):
        """Meta-device stand-ins of ``repro``'s param tree (the specs'
        shapes and dtypes, the stacks unsplit)."""
        return abstract_params(self.specs)

    def cache_specs(self, batch: int, max_len: int):
        """Meta-device stand-ins of ``init_cache(batch, max_len)``."""
        return self.init_cache(batch, max_len, device="meta")

    def _cache_len(self, max_len):
        w = self.cfg.sliding_window
        return min(max_len, w) if w else max_len

    def _kv(self, n, batch, t, device, kv_heads=None):
        shape = (n, batch, t, kv_heads or self.cfg.n_kv_heads, self.cfg.hd)
        return (torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
                torch.zeros(shape, dtype=CACHE_DTYPE, device=device))

    def _embed(self, tokens, mesh=None, sp=False):
        """The token rows; with ``sp`` this rank's sequence block of them
        (``layers.embed``)."""
        if mesh is None:
            return embed(self.embed, tokens)
        return embed(self.embed, tokens, mesh, self.cfg.vocab, sp)

    def _logits(self, x, mesh=None, sp=False):
        """f32 logits of the hidden state x (with ``sp`` this rank's
        sequence block, gathered whole first, as ``repro``'s
        ``shard_act(x, BATCH, None, None)``); this rank's vocab block
        where the unembedding (or the tied table) is a block over "model"
        (x enters it through ``psum_bwd``)."""
        x = seq_whole(x, mesh, sp)
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        tied = self.cfg.tie_embeddings
        w = self.embed["table"] if tied else self.unembed["w"]
        if model_block(mesh, w.shape[0 if tied else 1], self.cfg.vocab):
            x = psum_bwd(x, mesh, "model")
        if tied:
            return x.float() @ w.float().T
        return unembed(self.unembed, x)


class DenseModel(Model):
    """L x [attn + ffn] decoder (``repro``'s ``build_dense``)."""

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        block = tf.dense_block_spec(cfg)
        specs = dict(_head_specs(cfg))
        specs["blocks"] = stack(block, cfg.n_layers)
        super().__init__(cfg, specs, device, trainable)
        self.blocks = self._stack(block, cfg.n_layers, device)

    def forward(self, run, batch, mesh=None):
        tokens = batch["tokens"]
        sp = seq_parallel(mesh, tokens.shape[1])
        x = self._embed(tokens, mesh, sp)
        pos = _positions(tokens.shape[1], x.device)
        blk = _wrap_remat(
            lambda p, x: tf.dense_block(self._take(p), self.cfg, run, x, pos,
                                        mesh), run)
        for p in self.blocks:
            x = blk(p, x)
        return self._logits(x, mesh, sp), {}

    @torch.inference_mode()
    def init_cache(self, batch, max_len, device=None, kv_heads=None):
        """Zeros; ``kv_heads``: the kv heads a rank holds (a block over
        "model", ``runtime.steps.local_cache``), else all of them."""
        dev = device or self.device
        k, v = self._kv(self.cfg.n_layers, batch, self._cache_len(max_len),
                        dev, kv_heads)
        return {"k": k, "v": v,
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.inference_mode()
    def decode_step(self, run, tokens, cache, mesh=None):
        x = self._embed(tokens, mesh)
        pos = cache["pos"]
        for i, p in enumerate(self.blocks):
            x, _, _ = tf.dense_block_decode(self._take(p), self.cfg, x,
                                            cache["k"][i],
                                            cache["v"][i], pos, mesh)
        return self._logits(x, mesh), {"k": cache["k"], "v": cache["v"],
                                       "pos": pos + 1}

    @torch.inference_mode()
    def prefill(self, run, tokens, max_len):
        """Run the prompt once, returning (last-position logits, cache)
        ready for ``decode_step``."""
        cfg = self.cfg
        b, s = tokens.shape
        x = embed(self.embed, tokens)
        t = self._cache_len(max_len)
        n = min(s, t)
        cache = self.init_cache(b, max_len)
        sin, cos = rope_tables(_positions(s, x.device), cfg.hd,
                               cfg.rope_theta)
        for i, p in enumerate(self.blocks):
            h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
            q, k, v = gqa_project_qkv(p["attn"], cfg, h, rope=(sin, cos))
            o = self_attn(q, repeat_kv(k, cfg.n_heads),
                          repeat_kv(v, cfg.n_heads), causal=True,
                          window=cfg.sliding_window,
                          chunk_q=run.attn_chunk_q,
                          chunk_kv=run.attn_chunk_kv)
            x = x + dense(p["attn"]["wo"], o.reshape(b, s, -1))
            x = x + ffn(p["ffn"], rmsnorm(p["ffn_norm"], x, cfg.norm_eps),
                        cfg.act)
            cache["k"][i, :, :n] = k[:, s - n:]
            cache["v"][i, :, :n] = v[:, s - n:]
        cache["pos"].fill_(s)
        return self._logits(x[:, -1:, :]), cache


class MoEModel(Model):
    """``first_dense_layers`` x [attn + ffn] then the rest x [attn + MoE]
    (``repro``'s ``build_moe``): Mixtral (GQA, a sliding window) and
    DeepSeek-V2 (MLA, a dense first layer, shared experts).  No
    ``prefill``, as in ``repro``."""

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        fd = cfg.first_dense_layers
        specs = dict(_head_specs(cfg))
        if fd:
            specs["dense_blocks"] = stack(tf.dense_block_spec(cfg), fd)
        specs["blocks"] = stack(tf.moe_block_spec(cfg), cfg.n_layers - fd)
        super().__init__(cfg, specs, device, trainable)
        if fd:
            self.dense_blocks = self._stack(tf.dense_block_spec(cfg), fd,
                                            device)
        self.blocks = self._stack(tf.moe_block_spec(cfg),
                                  cfg.n_layers - fd, device)

    def _dense(self):
        return self.dense_blocks if self.cfg.first_dense_layers else ()

    def forward(self, run, batch, mesh=None):
        """(logits, aux): aux["lb_loss"] the mean of the MoE layers'
        load-balance losses, aux["dropped"] the sum of their dropped
        (token, choice) pairs (i32)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        sp = seq_parallel(mesh, tokens.shape[1])
        x = self._embed(tokens, mesh, sp)
        pos = _positions(tokens.shape[1], x.device)
        dblk = _wrap_remat(
            lambda p, x: tf.dense_block(self._take(p), cfg, run, x, pos,
                                        mesh), run)
        for p in self._dense():
            x = dblk(p, x)
        mblk = _wrap_remat(
            lambda p, x: tf.moe_block(self._take(p), cfg, run, x, pos, mesh),
            run)
        lb, dropped = [], []
        for p in self.blocks:
            x, aux = mblk(p, x)
            lb.append(aux["lb_loss"])
            dropped.append(aux["dropped"])
        aux = {"lb_loss": torch.stack(lb).mean(),
               "dropped": torch.stack(dropped).sum(dtype=torch.int32)}
        return self._logits(x, mesh, sp), aux

    @torch.inference_mode()
    def init_cache(self, batch, max_len, device=None, kv_heads=None):
        """Zeros; ``kv_heads`` as ``DenseModel.init_cache``'s."""
        cfg = self.cfg
        dev = device or self.device
        fd = cfg.first_dense_layers
        n = cfg.n_layers - fd
        c = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
        if cfg.mla:
            c["ckv"] = torch.zeros((n, batch, max_len, cfg.kv_lora),
                                   dtype=CACHE_DTYPE, device=dev)
            c["kr"] = torch.zeros((n, batch, max_len, cfg.qk_rope_dim),
                                  dtype=CACHE_DTYPE, device=dev)
        else:
            c["k"], c["v"] = self._kv(n, batch, self._cache_len(max_len),
                                      dev, kv_heads)
        if fd:
            c["dense_k"], c["dense_v"] = self._kv(fd, batch, max_len, dev,
                                                  kv_heads)
        return c

    @torch.inference_mode()
    def decode_step(self, run, tokens, cache, mesh=None):
        cfg = self.cfg
        x = self._embed(tokens, mesh)
        pos = cache["pos"]
        for i, p in enumerate(self._dense()):
            x, _, _ = tf.dense_block_decode(self._take(p), cfg, x,
                                            cache["dense_k"][i],
                                            cache["dense_v"][i], pos, mesh)
        names = ("ckv", "kr") if cfg.mla else ("k", "v")
        for i, p in enumerate(self.blocks):
            x, _ = tf.moe_block_decode(self._take(p), cfg, x,
                                       {k: cache[k][i] for k in names}, pos,
                                       mesh)
        return self._logits(x, mesh), dict(cache, pos=pos + 1)


class VLMModel(Model):
    """G groups of (k-1) self blocks and one gated cross-attention block
    over the image tokens (``repro``'s ``build_vlm``, llama-3.2-vision).
    ``forward`` recomputes each group's image K / V from ``batch["img"]``
    [B, n_img, d_vision] cast to bf16.  No ``prefill``, as in ``repro``.

    Decode never fills the image caches: ``init_cache`` zeroes ``img_k``
    / ``img_v`` and ``decode_step`` only reads them, as ``repro``'s do.
    So decode's cross-attention adds nothing (zero values, ``wo`` has no
    bias) while its gated FFN still runs, and a decode step agrees with a
    teacher-forced ``forward`` only where the attention gate is 0."""

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        k = cfg.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are no "
                             f"multiple of cross_attn_every {k}")
        self.n_groups = cfg.n_layers // k
        selfs, cross = tf.dense_block_spec(cfg), tf.cross_block_spec(cfg)
        specs = dict(_head_specs(cfg))
        specs["groups"] = stack({"selfs": stack(selfs, k - 1),
                                 "cross": cross}, self.n_groups,
                                axis_name="groups")
        super().__init__(cfg, specs, device, trainable)
        self.groups = nn.ModuleList(
            nn.ModuleDict({"selfs": self._stack(selfs, k - 1, device),
                           "cross": self._block(cross, device)})
            for _ in range(self.n_groups))

    def forward(self, run, batch, mesh=None):
        cfg = self.cfg
        tokens = batch["tokens"]
        img = batch["img"].to(ACT_DTYPE)
        sp = seq_parallel(mesh, tokens.shape[1])
        x = self._embed(tokens, mesh, sp)
        pos = _positions(tokens.shape[1], x.device)
        sblk = _wrap_remat(
            lambda p, x: tf.dense_block(self._take(p), cfg, run, x, pos,
                                        mesh), run)
        for group in self.groups:
            for p in group["selfs"]:
                x = sblk(p, x)
            # Not rematerialized, as in repro.
            c = self._take(group["cross"])
            kv = tf.cross_img_kv(c, cfg, img, mesh)
            x = tf.cross_block(c, cfg, run, x, kv, mesh, sp)
            del c, kv
        return self._logits(x, mesh, sp), {}

    @torch.inference_mode()
    def init_cache(self, batch, max_len, device=None, kv_heads=None):
        """Zeros; ``kv_heads`` (of the self and image caches) as
        ``DenseModel.init_cache``'s."""
        cfg = self.cfg
        dev = device or self.device
        g, k = self.n_groups, cfg.cross_attn_every
        kh = kv_heads or cfg.n_kv_heads
        shape = (g, k - 1, batch, max_len, kh, cfg.hd)
        ishape = (g, batch, cfg.n_img_tokens, kh, cfg.hd)
        c = {name: torch.zeros(sh, dtype=CACHE_DTYPE, device=dev)
             for name, sh in (("k", shape), ("v", shape), ("img_k", ishape),
                              ("img_v", ishape))}
        c["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
        return c

    @torch.inference_mode()
    def decode_step(self, run, tokens, cache, mesh=None):
        cfg = self.cfg
        x = self._embed(tokens, mesh)
        pos = cache["pos"]
        for g, group in enumerate(self.groups):
            for j, p in enumerate(group["selfs"]):
                x, _, _ = tf.dense_block_decode(self._take(p), cfg, x,
                                                cache["k"][g, j],
                                                cache["v"][g, j], pos, mesh)
            x = tf.cross_block_decode(self._take(group["cross"]), cfg, x,
                                      cache["img_k"][g], cache["img_v"][g],
                                      mesh)
        return self._logits(x, mesh), dict(cache, pos=pos + 1)


def _dec_spec(cfg):
    """An encdec decoder block: causal self-attention, cross-attention
    over the encoder's output, the FFN."""
    return {"self_norm": rmsnorm_spec(cfg.d_model),
            "self": gqa_spec(cfg),
            "cross_norm": rmsnorm_spec(cfg.d_model),
            "cross": gqa_spec(cfg),
            "ffn_norm": rmsnorm_spec(cfg.d_model),
            "ffn": ffn_spec(cfg.d_model, cfg.d_ff, cfg.act)}


class EncDecModel(Model):
    """``enc_layers`` bidirectional encoder blocks over ``batch["frames"]``
    [B, S_enc, d] (cast to bf16) and ``enc_norm``, then ``n_layers``
    decoder blocks (``repro``'s ``build_encdec``, seamless-m4t).  The
    encoder's self-attention is flash's full route, the decoder's its
    causal one; the cross-attention (no RoPE) stays ``blockwise_attn``.
    No ``prefill``, as in ``repro``.

    Decode never fills ``cross_k`` / ``cross_v``: ``init_cache`` zeroes
    them and ``decode_step`` only reads them, as ``repro``'s do, so
    decode's cross-attention adds nothing and decode does not agree with
    a teacher-forced ``forward``."""

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        enc, dec = tf.dense_block_spec(cfg), _dec_spec(cfg)
        specs = dict(_head_specs(cfg))
        specs["enc_blocks"] = stack(enc, cfg.enc_layers)
        specs["enc_norm"] = rmsnorm_spec(cfg.d_model)
        specs["dec_blocks"] = stack(dec, cfg.n_layers)
        super().__init__(cfg, specs, device, trainable)
        self.enc_blocks = self._stack(enc, cfg.enc_layers, device)
        self.dec_blocks = self._stack(dec, cfg.n_layers, device)

    def encode(self, run, frames, mesh=None):
        cfg = self.cfg
        pos = _positions(frames.shape[1], frames.device)
        blk = _wrap_remat(
            lambda p, x: tf.dense_block_bidir(self._take(p), cfg, run, x, pos,
                                              mesh), run)
        # The encoder's residual is sequence-parallel where its length
        # divides; the decoder's cross K / V read its output whole.
        x, sp = seq_block(frames, mesh)
        for p in self.enc_blocks:
            x = blk(p, x)
        return rmsnorm(self.enc_norm, seq_whole(x, mesh, sp), cfg.norm_eps)

    def _dec_block(self, p, x, enc_out, pos, run, mesh=None):
        cfg = self.cfg
        x = x + gqa_self_attn(p["self"], cfg,
                              rmsnorm(p["self_norm"], x, cfg.norm_eps),
                              positions=pos, chunk_q=run.attn_chunk_q,
                              chunk_kv=run.attn_chunk_kv, mesh=mesh)
        k, v = cross_kv(p["cross"], cfg, enc_out, mesh)
        x = x + cross_attn(p["cross"], cfg,
                           rmsnorm(p["cross_norm"], x, cfg.norm_eps), k, v,
                           chunk_q=run.attn_chunk_q,
                           chunk_kv=run.attn_chunk_kv, mesh=mesh)
        return x + ffn(p["ffn"], rmsnorm(p["ffn_norm"], x, cfg.norm_eps),
                       cfg.act, mesh, cfg.d_ff)

    def forward(self, run, batch, mesh=None):
        tokens = batch["tokens"]
        enc_out = self.encode(run, batch["frames"].to(ACT_DTYPE), mesh)
        x = self._embed(tokens, mesh)
        pos = _positions(tokens.shape[1], x.device)
        blk = _wrap_remat(
            lambda p, x: self._dec_block(self._take(p), x, enc_out, pos, run,
                                         mesh), run)
        for p in self.dec_blocks:
            x = blk(p, x)
        return self._logits(x, mesh), {}

    @torch.inference_mode()
    def init_cache(self, batch, max_len, device=None, kv_heads=None):
        """Zeros; ``kv_heads`` (of the self and cross caches) as
        ``DenseModel.init_cache``'s."""
        dev = device or self.device
        n = self.cfg.n_layers
        k, v = self._kv(n, batch, max_len, dev, kv_heads)
        ck, cv = self._kv(n, batch, max_len, dev, kv_heads)
        return {"k": k, "v": v, "cross_k": ck, "cross_v": cv,
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.inference_mode()
    def decode_step(self, run, tokens, cache, mesh=None):
        cfg = self.cfg
        x = self._embed(tokens, mesh)
        pos = cache["pos"]
        for i, p in enumerate(self.dec_blocks):
            p = self._take(p)
            a, _, _ = gqa_decode_self_attn(
                p["self"], cfg, rmsnorm(p["self_norm"], x, cfg.norm_eps),
                cache["k"][i], cache["v"][i], pos, mesh)
            x = x + a
            x = x + cross_decode_attn(
                p["cross"], cfg, rmsnorm(p["cross_norm"], x, cfg.norm_eps),
                cache["cross_k"][i], cache["cross_v"][i], mesh)
            x = x + ffn(p["ffn"], rmsnorm(p["ffn_norm"], x, cfg.norm_eps),
                        cfg.act, mesh, cfg.d_ff)
        return self._logits(x, mesh), dict(cache, pos=pos + 1)


def _stacked_zeros(state: dict, lead: tuple) -> dict:
    """Zeros of each state leaf's shape and dtype with the ``lead`` axes
    prepended (``repro``'s ``jax.tree.map(jnp.zeros((g, k) + a.shape))``:
    an -inf stabilizer of the one-layer state becomes 0 too)."""
    return {k: torch.zeros(lead + tuple(a.shape), dtype=a.dtype,
                           device=a.device) for k, a in state.items()}


def _step_into(step, p, cfg, x, state: dict):
    """``x + y`` of one recurrent block's decode step, its new state
    copied into the cache slices ``state`` (the conv state's bf16 values
    exact in the f32 cache)."""
    y, new = step(p, cfg, x, state)
    for k, t in state.items():
        t.copy_(new[k])
    return x + y


class SSMHybridModel(Model):
    """zamba2 (``repro``'s ``build_ssm_hybrid``): G groups of k Mamba2
    blocks, each group followed by the one shared attention + FFN block
    with the group's own LoRA on q, then ``n_layers % k`` more Mamba2
    blocks (the tail).  The shared block's causal self-attention runs on
    the flash kernel, once a group.  No ``prefill``, as in ``repro``.

    ``init_cache`` holds the SSM states stacked [G, k, ...] (``ssm``) and
    [tail, ...] (``tail_ssm``), all f32 as ``repro``'s are at init; the
    conv state stays f32 after a step (``repro``'s turns bf16 there: the
    same values), and ``attn_k`` / ``attn_v`` [G, B, T, KH, hd]."""

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        k = cfg.shared_attn_every
        self.n_groups, self.n_tail = divmod(cfg.n_layers, k)
        mamba, lora = ssm.mamba2_spec(cfg), tf.shared_lora_spec(cfg)
        shared = tf.shared_attn_spec(cfg)
        specs = dict(_head_specs(cfg))
        specs["shared"] = shared
        specs["groups"] = stack({"mambas": stack(mamba, k), "lora": lora},
                                self.n_groups, axis_name="groups")
        if self.n_tail:
            specs["tail"] = stack(mamba, self.n_tail)
        super().__init__(cfg, specs, device, trainable)
        self.shared = self._block(shared, device)
        self.groups = nn.ModuleList(
            nn.ModuleDict({"mambas": self._stack(mamba, k, device),
                           "lora": self._block(lora, device)})
            for _ in range(self.n_groups))
        if self.n_tail:
            self.tail = self._stack(mamba, self.n_tail, device)

    def _tail(self):
        return self.tail if self.n_tail else ()

    def forward(self, run, batch, mesh=None):
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(tokens, mesh)
        pos = _positions(tokens.shape[1], x.device)
        mblk = _wrap_remat(
            lambda p, x: x + ssm.mamba2(self._take(p), cfg, x,
                                        chunk=run.ssm_chunk, mesh=mesh), run)
        for group in self.groups:
            for p in group["mambas"]:
                x = mblk(p, x)
            x = tf._shared_attn(self.shared, self._take(group["lora"]), cfg,
                                run, x, pos, mesh)
        for p in self._tail():
            x = mblk(p, x)
        return self._logits(x, mesh), {}

    @torch.inference_mode()
    def init_cache(self, batch, max_len, device=None, kv_heads=None,
                   heads=None):
        """Zeros; ``heads``: the Mamba2 heads a rank holds, ``kv_heads``
        the shared block's (blocks over "model",
        ``runtime.steps.local_cache``), else all of them."""
        cfg = self.cfg
        dev = device or self.device
        one = ssm.mamba2_init_state(cfg, batch, cfg.d_model, device=dev,
                                    heads=heads)
        g, k = self.n_groups, cfg.shared_attn_every
        ak, av = self._kv(g, batch, max_len, dev, kv_heads)
        cache = {"ssm": _stacked_zeros(one, (g, k)), "attn_k": ak,
                 "attn_v": av,
                 "pos": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.n_tail:
            cache["tail_ssm"] = _stacked_zeros(one, (self.n_tail,))
        return cache

    @torch.inference_mode()
    def decode_step(self, run, tokens, cache, mesh=None):
        cfg = self.cfg
        x = self._embed(tokens, mesh)
        pos = cache["pos"]
        step = functools.partial(ssm.mamba2_step, mesh=mesh)
        for g, group in enumerate(self.groups):
            for j, p in enumerate(group["mambas"]):
                x = _step_into(step, self._take(p), cfg, x,
                               {k: t[g, j] for k, t in cache["ssm"].items()})
            x, _, _ = tf._shared_attn_decode(
                self.shared, self._take(group["lora"]), cfg, x,
                cache["attn_k"][g],
                cache["attn_v"][g], pos, mesh)
        for j, p in enumerate(self._tail()):
            x = _step_into(step, self._take(p), cfg, x,
                           {k: t[j] for k, t in cache["tail_ssm"].items()})
        return self._logits(x, mesh), dict(cache, pos=pos + 1)


class XLSTMModel(Model):
    """xLSTM (``repro``'s ``build_xlstm``): with ``slstm_every`` = k > 0,
    G = n_layers / k groups of k-1 mLSTM blocks and one sLSTM block;
    with k = 0, a flat ``blocks`` stack of mLSTMs.  No attention, so no
    kernel of the port's; no ``prefill``, as in ``repro``.

    ``init_cache`` is zeros, as ``repro``'s: the mLSTM states "m" ({C, n,
    m} [G, k-1, B, ...], or [L, B, ...]) and the sLSTM's "s" ({c, n, h,
    m} [G, B, h, dh]) in f32, the stabilizers m included (the one-layer
    ``*_init_state`` start them at -inf, as the forward does; from 0 the
    sLSTM's first steps normalize by max(|n|, 1) with n < 1, so decode
    from ``init_cache`` departs from a teacher-forced forward, in
    ``repro`` as here)."""

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        k = cfg.slstm_every
        mblock, sblock = xlstm.mlstm_spec(cfg), xlstm.slstm_spec(cfg)
        specs = dict(_head_specs(cfg))
        if k:
            if cfg.n_layers % k:
                raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are no "
                                 f"multiple of slstm_every {k}")
            self.n_groups = cfg.n_layers // k
            specs["groups"] = stack({"mlstms": stack(mblock, k - 1),
                                     "slstm": sblock}, self.n_groups,
                                    axis_name="groups")
        else:
            self.n_groups = 0
            specs["blocks"] = stack(mblock, cfg.n_layers)
        super().__init__(cfg, specs, device, trainable)
        if k:
            self.groups = nn.ModuleList(
                nn.ModuleDict({"mlstms": self._stack(mblock, k - 1, device),
                               "slstm": self._block(sblock, device)})
                for _ in range(self.n_groups))
        else:
            self.blocks = self._stack(mblock, cfg.n_layers, device)

    def forward(self, run, batch, mesh=None):
        cfg = self.cfg
        x = self._embed(batch["tokens"], mesh)
        mblk = _wrap_remat(
            lambda p, x: x + xlstm.mlstm(self._take(p), cfg, x,
                                         chunk=run.ssm_chunk, mesh=mesh), run)
        if not self.n_groups:
            for p in self.blocks:
                x = mblk(p, x)
        else:
            for group in self.groups:
                for p in group["mlstms"]:
                    x = mblk(p, x)
                x = x + xlstm.slstm(self._take(group["slstm"]), cfg, x, mesh)
        return self._logits(x, mesh), {}

    @torch.inference_mode()
    def init_cache(self, batch, max_len, device=None, heads=None):
        """Zeros; ``heads``: the heads a rank holds (a block over "model",
        ``runtime.steps.local_cache``), else all of them."""
        cfg = self.cfg
        dev = device or self.device
        m_one = xlstm.mlstm_init_state(cfg, batch, device=dev, heads=heads)
        c = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.n_groups:
            c["m"] = _stacked_zeros(m_one, (self.n_groups,
                                            cfg.slstm_every - 1))
            c["s"] = _stacked_zeros(xlstm.slstm_init_state(
                cfg, batch, device=dev, heads=heads), (self.n_groups,))
        else:
            c["m"] = _stacked_zeros(m_one, (cfg.n_layers,))
        return c

    @torch.inference_mode()
    def decode_step(self, run, tokens, cache, mesh=None):
        cfg = self.cfg
        x = self._embed(tokens, mesh)
        mstep = functools.partial(xlstm.mlstm_step, mesh=mesh)
        if not self.n_groups:
            for i, p in enumerate(self.blocks):
                x = _step_into(mstep, self._take(p), cfg, x,
                               {k: t[i] for k, t in cache["m"].items()})
        else:
            sstep = functools.partial(xlstm.slstm_step, mesh=mesh)
            for g, group in enumerate(self.groups):
                for j, p in enumerate(group["mlstms"]):
                    x = _step_into(mstep, self._take(p), cfg, x,
                                   {k: t[g, j]
                                    for k, t in cache["m"].items()})
                x = _step_into(sstep, self._take(group["slstm"]), cfg, x,
                               {k: t[g] for k, t in cache["s"].items()})
        return self._logits(x, mesh), dict(cache, pos=cache["pos"] + 1)


_BUILDERS = {"dense": DenseModel, "moe": MoEModel, "vlm": VLMModel,
             "encdec": EncDecModel, "ssm_hybrid": SSMHybridModel,
             "xlstm": XLSTMModel}


def build_model(cfg: ModelConfig, device="cuda", *,
                trainable: bool = False) -> Model:
    """The port's model for ``cfg``, its parameters allocated (not
    initialized) on ``device``: load them with ``params_from_numpy`` or
    ``init_params_into``.  ``trainable`` builds it to train (see the
    module doc)."""
    if cfg.family not in _BUILDERS:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return _BUILDERS[cfg.family](cfg, device, trainable)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                model: Model | None = None) -> dict:
    """Meta-device stand-ins for every model input of a cell (``repro``'s
    ``ShapeDtypeStruct``s).

    For train / prefill: the token batch (+ modality stubs).  For
    decode: a one-token batch and a full cache at ``seq_len``.
    """
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        d = {"tokens": meta(b, s)}
        if shape.kind == "train":
            d["labels"] = meta(b, s)
        if cfg.family == "vlm":
            d["img"] = meta(b, cfg.n_img_tokens, cfg.d_vision,
                            dtype=torch.bfloat16)
        if cfg.family == "encdec":
            d["frames"] = meta(b, s, cfg.d_model, dtype=torch.bfloat16)
        return d
    model = model or build_model(cfg, "meta")
    return {"tokens": meta(b, 1), "cache": model.cache_specs(b, s)}
