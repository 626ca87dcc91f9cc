"""Shared by tests/test_torch_moe.py and tests/test_torch_mla.py: a
reduced MoE config's ``repro`` model and params beside the port's model
carrying the same weights, and the routing record that tells a real
difference from a near tie.

Routing is the one discontinuous step of the MoE stack.  The router
reads activations that the two packages round to bf16 in other places,
so where a token's k-th and (k+1)-th probabilities are nearly tied, the
two can pick different experts; the token's layer output then differs
by a whole expert's contribution, and so can the output of another
token whose slot in a full bucket that choice took or freed (capacity
drops).  Those tokens are *affected*.  The tests hold:

* every choice that differs is a near tie in ``repro``'s probabilities
  (the gap between the k-th and (k+1)-th below ``ROUTE_GAP``), or
  belongs to a token already affected in an earlier layer, or (decode)
  to a row with an affected earlier position, whose inputs differ by
  more than rounding;
* the logits of every token not affected, within the stated tolerance
  (a later position reads an affected one through attention, which
  moves it by far less than the expert did);
* at least ``MIN_CLEAR`` of the tokens not affected (so no check is
  vacuous).

``ROUTE_GAP`` is 2^-6: the two packages' router probabilities at tokens
not affected differ by at most ~5e-3 on these seeds (bf16 activations,
two or three layers); a gap above 2^-6 has to be decided alike.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.moe as j_moe
from repro import configs as j_configs
from repro.configs.base import RunConfig as JRunConfig
from repro.models.model import build_model as j_build_model
from repro.models.module import init_params as j_init_params
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.models import module
from repro_torch.models import moe as t_moe
from repro_torch.models.model import build_model

ROUTE_GAP = 2.0 ** -6
MIN_CLEAR = 0.75
LOGIT_ATOL = 0.1
KNOBS = dict(remat="none", attn_chunk_q=16, attn_chunk_kv=16)
RUN = RunConfig(**KNOBS)
J_RUN = JRunConfig(**KNOBS)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def margin(logits):
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def configs_of(arch, **changes):
    """(the port's, repro's) reduced config of ``arch`` with ``changes``."""
    import dataclasses
    return (dataclasses.replace(configs.get_reduced_config(arch), **changes),
            dataclasses.replace(j_configs.get_reduced_config(arch),
                                **changes))


class Pair:
    """One reduced MoE config's repro model and params, and the port's
    model (serving build, or ``trainable``) carrying the same weights."""

    def __init__(self, arch, trainable=False, seed=0, **changes):
        self.cfg, jcfg = configs_of(arch, **changes)
        self.jm = j_build_model(jcfg)
        self.jp = j_init_params(self.jm.specs, jax.random.key(seed))
        self.tm = self.model(trainable)
        self._fwd = jax.jit(lambda p, t: self.jm.forward(
            p, J_RUN, {"tokens": t}))
        self._dec = jax.jit(lambda p, t, c: self.jm.decode_step(
            p, J_RUN, t, c))

    def model(self, trainable=False):
        tm = build_model(self.cfg, "cpu", trainable=trainable)
        module.params_from_numpy(tm, jax.tree.map(np.array, self.jp))
        return tm

    def j_forward(self, toks):
        logits, aux = self._fwd(self.jp, jnp.asarray(toks))
        return np.asarray(logits), aux

    def j_decode(self, tok, cache):
        return self._dec(self.jp, jnp.asarray(tok), cache)


class Routes:
    """The router calls of both packages while ``record()`` is open, in
    order: ``repro``'s (probabilities [T, E], ids [T, k]) in ``j`` and the
    port's ids in ``t``.  ``install()`` wraps both ``_router``s for a
    test module's run (before anything is traced: ``repro``'s record is a
    ``jax.debug.callback`` traced into the jitted passes), ``uninstall()``
    restores them."""

    def __init__(self):
        self.j, self.t, self.on = [], [], False
        self._saved = None

    def install(self):
        j_router, t_router = j_moe._router, t_moe._router
        self._saved = (j_router, t_router)

        def keep_j(p, i):
            if self.on:
                self.j.append((np.asarray(p), np.asarray(i)))

        def jr(params, cfg, x2d):
            out = j_router(params, cfg, x2d)
            probs = jax.nn.softmax(jnp.einsum(
                "td,de->te", x2d.astype(jnp.float32),
                params["router"]["w"].astype(jnp.float32)), axis=-1)
            jax.debug.callback(keep_j, probs, out[1], ordered=True)
            return out

        def tr(params, cfg, x2d):
            out = t_router(params, cfg, x2d)
            if self.on:
                self.t.append(out[1].numpy().copy())
            return out

        j_moe._router, t_moe._router = jr, tr

    def uninstall(self):
        j_moe._router, t_moe._router = self._saved

    @contextlib.contextmanager
    def record(self):
        self.j, self.t, self.on = [], [], True
        try:
            yield self
        finally:
            self.on = False


def _kept(ids, n_experts, capacity):
    """[T] frozensets of the experts that keep each token (its choices
    that fit the capacity: a bucket fills in token order)."""
    seen = np.zeros(n_experts, np.int64)
    out = []
    for row in ids:
        kept = set()
        for e in row:
            if seen[e] < capacity:
                kept.add(int(e))
            seen[e] += 1
        out.append(frozenset(kept))
    return out


def affected(cfg, jcalls, tcalls, before=None):
    """Check the router calls of one model pass in both packages (a
    forward, or one decode step: one call per MoE layer, in order;
    ``Routes.j`` / ``Routes.t`` or slices of them) as the module doc
    says; return the [T] mask of affected tokens.  A token's own output
    is what a differing choice changes; what later positions read of it
    through attention moves by far less, and is held to the tolerance.
    ``before`` [T] marks decode rows with an affected earlier position:
    their inputs differ by more than rounding, so a choice of theirs may
    differ at a gap above ``ROUTE_GAP`` (the row is then affected)."""
    assert len(jcalls) == len(tcalls) > 0
    hit = np.zeros(len(tcalls[0]), bool)
    excused = hit if before is None else before
    for layer, ((probs, jids), tids) in enumerate(zip(jcalls, tcalls)):
        cap = t_moe.capacity_of(cfg, len(jids))
        top = np.sort(probs, axis=-1)[:, ::-1]
        gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        flip = (np.sort(jids, -1) != np.sort(tids, -1)).any(-1)
        bad = flip & ~hit & ~excused & (gap >= ROUTE_GAP)
        assert not bad.any(), (layer, np.flatnonzero(bad), gap[bad])
        kept_j = _kept(jids, cfg.n_experts, cap)
        kept_t = _kept(tids, cfg.n_experts, cap)
        hit = hit | flip | np.array([a != b for a, b in zip(kept_j,
                                                             kept_t)])
    return hit


def lb_tol(cfg, n_tokens, n_hit):
    """How far the two packages' ``lb_loss`` may lie apart: 1e-3 for the
    router's inputs rounded in other places (me moves by ~1e-4), plus,
    for each affected token, its k choices moved between experts: ce
    moves by 1 / (T k) at two experts each, me <= 1: 2 E / T a token."""
    return 1e-3 + 2 * cfg.n_experts * n_hit / n_tokens
