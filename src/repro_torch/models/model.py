"""Model assembly (port of the dense family of src/repro/models/model.py).

``repro``'s ``Model`` is a record of pure functions over a param tree; the
port's is an ``nn.Module`` that holds its parameters (one ``ParamTree``
per block in an ``nn.ModuleList``, named after ``repro``'s tree:
``blocks.{i}.attn.wq.w``, ``embed.table``, ``unembed.w``) on an explicit
device, and whose methods drop the params argument:

  * ``forward(run, batch) -> (logits [B, S, V] f32, aux)``;
  * ``init_cache(batch, max_len) -> cache`` (zeros);
  * ``decode_step(run, tokens [B, 1], cache) -> (logits [B, 1, V], cache)``
    — the caches are written in place, one slot per layer;
  * ``prefill(run, tokens [B, S], max_len) -> (last logits [B, 1, V],
    cache)`` — the serving entry point.

All four run under ``torch.inference_mode()``.  The blocks' dense
weights and biases are stored in the activation dtype (bf16), cast once
at load: the same bits as ``repro``'s per-call cast in ``dense``.  Norm
scales, the embedding table and the unembedding stay f32 (``repro``
reads them in f32).  Self-attention without a sliding window goes
through the flash kernel (``attention.self_attn``), where ``repro``
calls ``blockwise_attn``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.attention import gqa_project_qkv, repeat_kv, \
    self_attn
from repro_torch.models.ffn import ffn
from repro_torch.models.layers import ACT_DTYPE, dense, embed, embed_spec, \
    rmsnorm, rmsnorm_spec, rope_tables, unembed, unembed_spec
from repro_torch.models.module import ParamTree, param_count, stack

CACHE_DTYPE = tf.CACHE_DTYPE

# The families still to port, and the ROADMAP (§1 item 12) slice that
# ports each.
_LATER = {
    "moe": "the MoE slice (mixtral), after training and checkpointing",
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


def _block_dtype(name: str, spec):
    """Dense weights and biases (leaves ``w`` / ``b``) in the activation
    dtype; everything else as its spec says."""
    return ACT_DTYPE if name.rsplit(".", 1)[-1] in ("w", "b") else spec.dtype


def _positions(s, device):
    return torch.arange(s, dtype=torch.int32, device=device)


class Model(nn.Module):
    """Base of the port's models: the config, the spec tree in
    ``repro``'s layout (stacked blocks) and the head parameters."""

    def __init__(self, cfg: ModelConfig, specs: dict, device):
        super().__init__()
        self.cfg = cfg
        self.specs = specs
        self.embed = ParamTree(specs["embed"], device)
        self.final_norm = ParamTree(specs["final_norm"], device)
        if "unembed" in specs:
            self.unembed = ParamTree(specs["unembed"], device)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def param_count(self) -> int:
        return param_count(self.specs)

    def _logits(self, x):
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x.float() @ self.embed["table"].float().T
        return unembed(self.unembed, x)


class DenseModel(Model):
    """L x [attn + ffn] decoder (``repro``'s ``build_dense``)."""

    def __init__(self, cfg: ModelConfig, device):
        block = tf.dense_block_spec(cfg)
        specs = dict(_head_specs(cfg))
        specs["blocks"] = stack(block, cfg.n_layers)
        super().__init__(cfg, specs, device)
        self.blocks = nn.ModuleList(
            ParamTree(block, device, _block_dtype)
            for _ in range(cfg.n_layers))

    def _cache_len(self, max_len):
        w = self.cfg.sliding_window
        return min(max_len, w) if w else max_len

    @torch.inference_mode()
    def forward(self, run, batch):
        tokens = batch["tokens"]
        x = embed(self.embed, tokens)
        pos = _positions(tokens.shape[1], x.device)
        for p in self.blocks:
            x = tf.dense_block(p, self.cfg, run, x, pos)
        return self._logits(x), {}

    @torch.inference_mode()
    def init_cache(self, batch, max_len):
        cfg = self.cfg
        shape = (cfg.n_layers, batch, self._cache_len(max_len),
                 cfg.n_kv_heads, cfg.hd)
        dev = self.device
        return {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=dev),
                "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=dev),
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


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The port's model for ``cfg``, its parameters allocated (not
    initialized) on ``device``: load them with ``params_from_numpy``."""
    if cfg.family == "dense":
        return DenseModel(cfg, device)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP §1 item 12: {_LATER[cfg.family]})")
    raise ValueError(f"unknown model family {cfg.family!r}")
