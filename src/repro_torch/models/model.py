"""Model assembly (port of the dense and MoE families of
src/repro/models/model.py).

``repro``'s ``Model`` is a record of pure functions over a param tree; the
port's is an ``nn.Module`` that holds its parameters (one ``ParamTree``
per layer of each stack in an ``nn.ModuleList``, named after ``repro``'s
tree: ``blocks.{i}.attn.wq.w``, ``dense_blocks.{i}.ffn.w_up.w``,
``embed.table``, ``unembed.w``) on an explicit device, and whose methods
drop the params argument:

  * ``forward(run, batch) -> (logits [B, S, V] f32, aux)`` — the training
    and teacher-forced path, differentiable; ``run.remat`` wraps each
    block in ``torch.utils.checkpoint`` as ``repro``'s ``_wrap_remat``
    wraps it in ``jax.checkpoint`` (when grad is enabled);
  * ``init_cache(batch, max_len) -> cache`` (zeros);
  * ``decode_step(run, tokens [B, 1], cache) -> (logits [B, 1, V], cache)``
    — the caches are written in place, one slot per layer;
  * ``prefill(run, tokens [B, S], max_len) -> (last logits [B, 1, V],
    cache)`` — the dense family's serving entry point.  The MoE family
    has none, as in ``repro``: its serving feeds the prompt through
    ``decode_step`` (``launch.serve``).

The last three run under ``torch.inference_mode()``.  ``cache_specs`` /
``abstract_params`` are meta-device stand-ins (shapes, no memory), and
``input_specs`` those of a cell's inputs.  Two builds:

  * serving (``trainable=False``, the default): each block leaf is
    stored in the dtype of its use (``_block_dtype``): bf16 for a leaf
    ``repro`` only ever casts to the activation dtype (dense weights and
    biases, the 3-D expert weights) — the same bits as ``repro``'s
    per-call cast, once at load; f32 for a leaf ``repro`` reads in f32
    (norm scales, the router, MLA's ``wuk`` / ``wuv``, which decode reads
    in f32); the embedding table and the unembedding stay f32; no
    parameter has a gradient;
  * training (``trainable=True``): every leaf in its spec's dtype (f32
    master weights, as ``repro``'s params are), with a gradient; ``dense``
    casts to bf16 on each call, as ``repro`` does.

Self-attention goes through the flash kernel where its shape allows
(``attention.self_attn``), where ``repro`` calls ``blockwise_attn``;
under autograd through ``make_flash_attn_trainable``.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.attention import gqa_project_qkv, repeat_kv, \
    self_attn
from repro_torch.models.ffn import ffn
from repro_torch.models.layers import ACT_DTYPE, dense, embed, embed_spec, \
    rmsnorm, rmsnorm_spec, rope_tables, unembed, unembed_spec
from repro_torch.models.module import ParamTree, abstract_params, \
    param_count, stack

CACHE_DTYPE = tf.CACHE_DTYPE

# The families still to port, and the ROADMAP (§1 item 6) slice that
# ports each.
_LATER = {
    "vlm": "the vlm slice, after MoE and MLA",
    "encdec": "the encdec slice, after vlm",
    "ssm_hybrid": "the ssm_hybrid slice, after encdec",
    "xlstm": "the xlstm slice, the last of the model stack",
}


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

    def _stack(self, block_spec: dict, n: int, device) -> nn.ModuleList:
        """One ``ParamTree`` per layer of a stack of ``n`` blocks."""
        return nn.ModuleList(
            ParamTree(block_spec, device,
                      None if self.trainable else _block_dtype,
                      requires_grad=self.trainable)
            for _ in range(n))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def param_count(self) -> int:
        return param_count(self.specs)

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

    def _kv(self, n, batch, t, device):
        shape = (n, batch, t, self.cfg.n_kv_heads, self.cfg.hd)
        return (torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
                torch.zeros(shape, dtype=CACHE_DTYPE, device=device))

    def _logits(self, x):
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x.float() @ self.embed["table"].float().T
        return unembed(self.unembed, x)


class DenseModel(Model):
    """L x [attn + ffn] decoder (``repro``'s ``build_dense``)."""

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        block = tf.dense_block_spec(cfg)
        specs = dict(_head_specs(cfg))
        specs["blocks"] = stack(block, cfg.n_layers)
        super().__init__(cfg, specs, device, trainable)
        self.blocks = self._stack(block, cfg.n_layers, device)

    def forward(self, run, batch):
        tokens = batch["tokens"]
        x = embed(self.embed, tokens)
        pos = _positions(tokens.shape[1], x.device)
        blk = _wrap_remat(
            lambda p, x: tf.dense_block(p, self.cfg, run, x, pos), run)
        for p in self.blocks:
            x = blk(p, x)
        return self._logits(x), {}

    @torch.inference_mode()
    def init_cache(self, batch, max_len, device=None):
        dev = device or self.device
        k, v = self._kv(self.cfg.n_layers, batch, self._cache_len(max_len),
                        dev)
        return {"k": k, "v": v,
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.inference_mode()
    def decode_step(self, run, tokens, cache):
        x = embed(self.embed, tokens)
        pos = cache["pos"]
        for i, p in enumerate(self.blocks):
            x, _, _ = tf.dense_block_decode(p, self.cfg, x, cache["k"][i],
                                            cache["v"][i], pos)
        return self._logits(x), {"k": cache["k"], "v": cache["v"],
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

    def forward(self, run, batch):
        """(logits, aux): aux["lb_loss"] the mean of the MoE layers'
        load-balance losses, aux["dropped"] the sum of their dropped
        (token, choice) pairs (i32)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed(self.embed, tokens)
        pos = _positions(tokens.shape[1], x.device)
        dblk = _wrap_remat(
            lambda p, x: tf.dense_block(p, cfg, run, x, pos), run)
        for p in self._dense():
            x = dblk(p, x)
        mblk = _wrap_remat(
            lambda p, x: tf.moe_block(p, cfg, run, x, pos), run)
        lb, dropped = [], []
        for p in self.blocks:
            x, aux = mblk(p, x)
            lb.append(aux["lb_loss"])
            dropped.append(aux["dropped"])
        aux = {"lb_loss": torch.stack(lb).mean(),
               "dropped": torch.stack(dropped).sum(dtype=torch.int32)}
        return self._logits(x), aux

    @torch.inference_mode()
    def init_cache(self, batch, max_len, device=None):
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
                                      dev)
        if fd:
            c["dense_k"], c["dense_v"] = self._kv(fd, batch, max_len, dev)
        return c

    @torch.inference_mode()
    def decode_step(self, run, tokens, cache):
        cfg = self.cfg
        x = embed(self.embed, tokens)
        pos = cache["pos"]
        for i, p in enumerate(self._dense()):
            x, _, _ = tf.dense_block_decode(p, cfg, x, cache["dense_k"][i],
                                            cache["dense_v"][i], pos)
        names = ("ckv", "kr") if cfg.mla else ("k", "v")
        for i, p in enumerate(self.blocks):
            x, _ = tf.moe_block_decode(p, cfg, x,
                                       {k: cache[k][i] for k in names}, pos)
        return self._logits(x), dict(cache, pos=pos + 1)


_BUILDERS = {"dense": DenseModel, "moe": MoEModel}


def build_model(cfg: ModelConfig, device="cuda", *,
                trainable: bool = False) -> Model:
    """The port's model for ``cfg``, its parameters allocated (not
    initialized) on ``device``: load them with ``params_from_numpy`` or
    ``init_params_into``.  ``trainable`` builds it to train (see the
    module doc)."""
    if cfg.family in _BUILDERS:
        return _BUILDERS[cfg.family](cfg, device, trainable)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP §1 item 6: {_LATER[cfg.family]})")
    raise ValueError(f"unknown model family {cfg.family!r}")


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
