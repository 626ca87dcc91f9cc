"""Shared by tests/test_torch_ssm.py and tests/test_torch_xlstm.py: a
reduced recurrent config's ``repro`` model and params beside the port's
model carrying the same weights, the inputs both take, and ``repro``
evaluated op by op.

Tolerances are ``tests/xattn_pair.py``'s (its doc says where each
comes from); each test names the one it uses.

**Why ``repro`` runs op by op here.**  Both families amplify bf16
rounding noise through their depth: the decay exp(-exp(A_log) dt) is an
exponential of a projection of the unnormalized residual stream, so an
ulp there moves every later state.  ``repro``'s own jitted forward of the
reduced zamba2 departs from the same function run op by op (XLA fuses
the bf16 ops of a scan body and rounds them otherwise) by 0.189 at the
logits, the reduced xLSTM's by 0.036, the reduced Qwen's by 0.031.  The
port rounds op by op, so ``Pair.j_forward`` / ``j_decode`` run ``repro``
under ``jax.disable_jit()``: every block then agrees bit for bit, and the
whole model to within rounding.  The port's flash twin (where ``repro``
calls ``blockwise_attn``) is held at the shared block; the whole-model
comparisons route the port's self-attention through ``blockwise_attn``
(``blockwise_self_attn``), since the twin alone moves the reduced
zamba2's logits by up to 0.128.

``Pair`` draws the leaves that ``repro`` zero-initializes and that would
hide a path: ``a_log`` / ``dt_bias`` from U(-1, 1) (the decay then varies
across heads) and the LoRA's ``b_q`` from N(0, 0.1^2) (0 at init: the
LoRA term is dead).
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import xattn_pair as xp
from repro import configs as j_configs
from repro.models.model import build_model as j_build_model
from repro.models.module import init_params as j_init_params
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, module
from repro_torch.models.model import build_model

KNOBS = dict(remat="none", attn_chunk_q=16, attn_chunk_kv=16, ssm_chunk=8)
RUN = RunConfig(**KNOBS)
J_RUN = xp.JRunConfig(**KNOBS)
TRAIN_KNOBS = dict(xp.TRAIN_KNOBS, ssm_chunk=8)
# Path segments of repro's trees whose leaves carry a stacked axis.
STACKED = ("blocks", "groups", "mambas", "tail", "mlstms")


def tokens(cfg, b, s, seed=0) -> dict:
    """A batch as numpy: tokens [B, S] and the next-token labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}


def live_leaves(tree, seed=1):
    """repro's tree with ``a_log`` / ``dt_bias`` drawn from U(-1, 1) and
    ``b_q`` from N(0, 0.1^2) wherever they occur (see the module doc)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("a_log", "dt_bias"):
                out[k] = rng.uniform(-1, 1, v.shape).astype(np.float32)
            elif k == "b_q":
                out[k] = (rng.normal(size=v.shape) / 10).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(tree)


@contextlib.contextmanager
def blockwise_self_attn():
    """The port's self-attention through ``blockwise_attn`` at RUN's
    chunks (the function ``repro`` calls there) in place of the flash
    kernel or its twin."""
    real = ops.flash_attn

    def blockwise(q, k, v, *, causal=True, **_):
        return attention.blockwise_attn(q, k, v, causal=causal,
                                        chunk_q=RUN.attn_chunk_q,
                                        chunk_kv=RUN.attn_chunk_kv)
    ops.flash_attn = blockwise
    try:
        yield
    finally:
        ops.flash_attn = real


class Pair:
    """One reduced config's repro model and params (the hidden leaves
    drawn live), and the port's model (serving build, or ``trainable``)
    carrying the same weights, on the CPU."""

    def __init__(self, arch, seed=0, **changes):
        self.cfg = dataclasses.replace(configs.get_reduced_config(arch),
                                       **changes)
        self.jm = j_build_model(dataclasses.replace(
            j_configs.get_reduced_config(arch), **changes))
        self.jp = live_leaves(jax.tree.map(np.array, j_init_params(
            self.jm.specs, jax.random.key(seed))))
        self.jpd = jax.tree.map(jnp.asarray, self.jp)
        self.tm = self.model()

    def model(self, trainable=False):
        tm = build_model(self.cfg, "cpu", trainable=trainable)
        module.params_from_numpy(tm, self.jp)
        return tm

    def j_forward(self, batch):
        """repro's forward logits, op by op (see the module doc)."""
        with jax.disable_jit():
            return np.asarray(self.jm.forward(
                self.jpd, J_RUN, xp.jax_batch(batch))[0])

    def t_forward(self, batch, model=None):
        with torch.no_grad():
            return (model or self.tm).forward(RUN, xp.torch_batch(batch))[0]

    def j_decode(self, tok, cache):
        with jax.disable_jit():
            return self.jm.decode_step(self.jpd, J_RUN, jnp.asarray(tok),
                                       cache)


def teacher_forced(pair, toks, steps, max_len):
    """Both packages' ``decode_step`` over the prompt ``toks`` [B, S] and
    then ``steps`` tokens of repro's greedy choice, fed to both: the
    logits within LOGIT_ATOL at every step, argmax equal where repro's
    margin is clear.  Returns (repro's cache, the port's cache, the
    number of argmax comparisons required)."""
    b, s = toks.shape
    jc = pair.jm.init_cache(b, max_len)
    tc = pair.tm.init_cache(b, max_len)
    feed, required = toks[:, :1], 0
    for i in range(s + steps):
        jl, jc = pair.j_decode(feed, jc)
        tl, tc = pair.tm.decode_step(RUN, torch.from_numpy(feed), tc)
        jl, tl = xp.np32(jl)[:, -1], xp.np32(tl)[:, -1]
        np.testing.assert_allclose(tl, jl, atol=xp.LOGIT_ATOL, rtol=0)
        clear = xp.margin(jl) > xp.LOGIT_ATOL
        np.testing.assert_array_equal(np.argmax(tl, -1)[clear],
                                      np.argmax(jl, -1)[clear])
        required += int(clear.sum())
        assert int(tc["pos"]) == int(jc["pos"]) == i + 1
        feed = toks[:, i + 1:i + 2] if i + 1 < s else \
            np.argmax(jl, -1).astype(np.int32)[:, None]
    return jc, tc, required


def split_names(jtree) -> dict:
    """{the port's parameter name: shape} of repro's abstract tree, every
    stacked axis of a path (``STACKED``) split."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        names, shape = [[]], tuple(leaf.shape)
        for key in (p.key for p in path):
            names = [n + [key] for n in names]
            if key in STACKED:
                names = [n + [str(i)] for n in names
                         for i in range(shape[0])]
                shape = shape[1:]
        out.update((".".join(n), shape) for n in names)
    return out


def same_specs(got: dict, want: dict) -> None:
    """Two {name: tensor or ShapeDtypeStruct} trees: the same names,
    shapes and dtypes."""
    got, want = module.flatten(got), module.flatten(want)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
