"""Shared by tests/test_torch_vlm.py and tests/test_torch_encdec.py: a
reduced cross-attention config's ``repro`` model and params beside the
port's model carrying the same weights, the inputs both take, and the
tolerances both files hold them to.

Both of the vlm's gates start at zero in ``repro`` (``tanh(0)`` = 0: at
init nothing of the image path reaches the output), so ``Pair`` draws
them from U(0.5, 1.5) in both trees; ``gate=0.0`` sets the attention
gate to 0 (the pinned decode check).

Tolerances (``tests/test_torch_models.py``'s and
``tests/test_torch_train.py``'s):

* ops on f32 inputs: 1e-6 absolute; a whole block on f32 inputs (several
  products and residual adds, summed in other orders): 1e-5 absolute
  and relative, ``test_ffn_matches_repro``'s;
* ops on bf16 inputs: two bf16 ulps (1 / 64 relative), plus 2^-8 where
  a block adds several rounded terms; a whole residual block (x + attn
  + ffn, each term rounded to bf16) two ulps at the residual stream's
  unit scale, 2^-6 absolute: where the terms cancel, the sum is off by
  an ulp of the terms, not of itself;
* whole-model logits (f32, scale ~4): 0.1 absolute; the port's
  self-attention runs the flash twin where ``repro`` runs
  ``blockwise_attn`` (the encoder's on the full route);
* bf16 caches: 0.0625 absolute plus two ulps;
* one train step: loss and ce within 5e-3 absolute, the grad norm
  within 5e-3 relative;
* decode is teacher-forced: argmax equality only where ``repro``'s
  top-2 margin exceeds the logit tolerance.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as j_configs
from repro.configs.base import RunConfig as JRunConfig
from repro.models.model import build_model as j_build_model
from repro.models.module import init_params as j_init_params
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops
from repro_torch.models import module
from repro_torch.models.model import build_model

F32_ATOL = 1e-6
BLOCK_F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -6
BF16_ATOL = 2.0 ** -8
BLOCK_BF16_ATOL = 2.0 ** -6
LOGIT_ATOL = 0.1
CACHE_ATOL = 0.0625
LOSS_ATOL, GNORM_RTOL = 5e-3, 5e-3
KNOBS = dict(remat="none", attn_chunk_q=16, attn_chunk_kv=16)
RUN = RunConfig(**KNOBS)
J_RUN = JRunConfig(**KNOBS)
TRAIN_KNOBS = dict(attn_chunk_q=16, attn_chunk_kv=16, learning_rate=1e-3,
                   warmup_steps=2, total_steps=100)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close_bf16(got, want, atol=0.0):
    np.testing.assert_allclose(np32(got), np32(want), rtol=BF16_RTOL,
                               atol=atol)


def margin(logits):
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def inputs(cfg, b, s, seed=0) -> dict:
    """A batch as numpy: tokens [B, S] (and labels), with the family's
    stub, ``img`` [B, n_img, d_vision] or ``frames`` [B, S, d], in f32
    (both packages cast it to bf16)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["img"] = rng.normal(size=(b, cfg.n_img_tokens,
                                      cfg.d_vision)).astype(np.float32)
    else:
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def jax_batch(batch, labels=False):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if labels or k != "labels"}


def torch_batch(batch, labels=False):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if labels or k != "labels"}


def set_gates(tree, seed=1, gate=None):
    """The vlm tree's gates drawn from U(0.5, 1.5) (``gate`` sets the
    attention gates to that value instead); other trees as they are."""
    if "groups" not in tree:
        return tree
    rng = np.random.default_rng(seed)
    cross = dict(tree["groups"]["cross"])
    for name in ("gate", "ffn_gate"):
        cross[name] = rng.uniform(0.5, 1.5, cross[name].shape).astype(
            np.float32)
    if gate is not None:
        cross["gate"] = np.full_like(cross["gate"], gate)
    return dict(tree, groups=dict(tree["groups"], cross=cross))


class Pair:
    """One reduced config's repro model and params (gates non-zero), and
    the port's model (serving build, or ``trainable``) carrying the same
    weights, on the CPU."""

    def __init__(self, arch, seed=0, gate=None, **changes):
        self.cfg = dataclasses.replace(configs.get_reduced_config(arch),
                                       **changes)
        self.jm = j_build_model(dataclasses.replace(
            j_configs.get_reduced_config(arch), **changes))
        self.jp = set_gates(jax.tree.map(np.array, j_init_params(
            self.jm.specs, jax.random.key(seed))), gate=gate)
        self.jpd = jax.tree.map(jnp.asarray, self.jp)
        self.tm = self.model()
        self._fwd = jax.jit(lambda p, b: self.jm.forward(p, J_RUN, b)[0])
        self._dec = jax.jit(lambda p, t, c: self.jm.decode_step(
            p, J_RUN, t, c))

    def model(self, trainable=False):
        tm = build_model(self.cfg, "cpu", trainable=trainable)
        module.params_from_numpy(tm, self.jp)
        return tm

    def j_forward(self, batch):
        return np.asarray(self._fwd(self.jpd, jax_batch(batch)))

    def t_forward(self, batch, model=None):
        with torch.no_grad():
            return (model or self.tm).forward(RUN, torch_batch(batch))[0]

    def j_decode(self, tok, cache):
        return self._dec(self.jpd, jnp.asarray(tok), cache)


class FlashCalls:
    """``ops.flash_attn``'s calls, (causal, q shape [B, S, H, D]), while
    installed with ``monkeypatch``; they still run (the twin here)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = ops.flash_attn

        def rec(q, k, v, *, causal=True, **kw):
            self.calls.append((causal, tuple(q.shape)))
            return real(q, k, v, causal=causal, **kw)
        monkeypatch.setattr(ops, "flash_attn", rec)


def teacher_forced(pair, toks, steps, max_len):
    """Both packages' ``decode_step`` over the prompt ``toks`` [B, S] and
    then ``steps`` tokens of ``repro``'s greedy choice, fed to both; the
    logits held within LOGIT_ATOL at every step and argmax equal where
    repro's margin is clear.  Returns (repro's cache, the port's cache,
    the number of argmax comparisons required)."""
    b, s = toks.shape
    jc = pair.jm.init_cache(b, max_len)
    tc = pair.tm.init_cache(b, max_len)
    feed, required = toks[:, :1], 0
    for i in range(s + steps):
        jl, jc = pair.j_decode(feed, jc)
        tl, tc = pair.tm.decode_step(RUN, torch.from_numpy(feed), tc)
        jl, tl = np32(jl)[:, -1], np32(tl)[:, -1]
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        clear = margin(jl) > LOGIT_ATOL
        np.testing.assert_array_equal(np.argmax(tl, -1)[clear],
                                      np.argmax(jl, -1)[clear])
        required += int(clear.sum())
        assert int(tc["pos"]) == int(jc["pos"]) == i + 1
        feed = toks[:, i + 1:i + 2] if i + 1 < s else \
            np.argmax(jl, -1).astype(np.int32)[:, None]
    return jc, tc, required


def split_names(jtree) -> dict:
    """{the port's parameter name: shape} of repro's abstract tree: every
    stacked axis of a path split (``blocks`` / ``enc_blocks`` /
    ``dec_blocks`` [L, ...]; the vlm's ``groups.selfs`` [G, k-1, ...] and
    ``groups.cross`` [G, ...])."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [p.key for p in path]
        names, shape = [[]], tuple(leaf.shape)
        for key in keys:
            names = [n + [key] for n in names]
            if key in ("blocks", "enc_blocks", "dec_blocks", "groups",
                       "selfs"):
                names = [n + [str(i)] for n in names
                         for i in range(shape[0])]
                shape = shape[1:]
        out.update((".".join(n), shape) for n in names)
    return out
