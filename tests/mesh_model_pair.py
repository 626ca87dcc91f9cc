"""Shared harness of tests/test_torch_mesh_model.py (no test file): the
model-side mesh cases both packages run on a (2, 4) ("data", "model")
mesh, the JAX package's run of them on 8 fake devices (jitted, in a
child interpreter), the port's run on gloo CPU ranks, and the spawn
that runs those ranks under a time limit.

``make_inputs`` writes the weights (``repro``'s ``init_params``) and
inputs both sides read ("w/..." and "in/..." keys); each side writes
{"{case}/{field}": array} to an npz of its own.  Only numpy is imported
at the top: the JAX child imports this module too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

XLA_FLAGS = "--xla_force_host_platform_device_count=8"
RANK_TIMEOUT_S = 120
MESH = (2, 4)
AXES = ("data", "model")
# moe_ffn cases: name -> (n_experts, batch rows).  E 8 splits the experts
# 2 a rank over "model"; E 2 cuts each into 2 virtual experts; a batch of
# 1 row does not divide over "data" and is replicated.
MOE_CASES = {"ep": (8, 4), "virtual": (2, 4), "replicated": (8, 1)}
MOE_SEQ = 16
MOE_CAPACITY = 0.5            # per-shard capacity drops choices
LB_COEF = 0.01                # the lb loss's weight in moe_ffn's objective
TRAIN_ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b")
TRAIN_B, TRAIN_S = 8, 32
OPT_STEP0 = 5                 # lr > 0 on the first step (warmup from 0)
RUN_KNOBS = dict(remat="none", attn_chunk_q=16, attn_chunk_kv=16,
                 learning_rate=1e-3, warmup_steps=2, total_steps=100)
DECODE_STEPS, DECODE_LEN = 4, 8
DATA_MESH = (8,)              # launch/train.py's ("data",) mesh
# The last three families (reduced) on (2, 4), tensor-parallel over
# "model": DeepSeek-V2 (MLA, 1 of 4 heads a rank, wuq re-blocked, the
# shared experts split), Zamba2 (2 of 8 Mamba2 heads and 1 of 4 attention
# heads a rank, in_proj re-blocked) and xLSTM (1 of 4 heads a rank):
# prefill, DECODE_STEPS of the serve loop and one train step against
# repro under the same mesh (DeepSeek-V2 routed as repro routed each call,
# LAST_ROUTES_FILE), remat "full" for two of them and "dots" for zamba2,
# the SSD / mLSTM chunk LAST_CHUNK (4 chunks a row).  zamba2's a_log /
# dt_bias are drawn from U(-1, 1) and its LoRA b_q from N(0, 0.1^2)
# (ssm_pair.live_leaves: repro's zeros hide those paths).
LAST_ARCHS = ("deepseek-v2-236b", "zamba2-1.2b", "xlstm-1.3b")
LAST_CHUNK = 8
LAST_REMAT = {"deepseek-v2-236b": "full", "zamba2-1.2b": "dots",
              "xlstm-1.3b": "full"}
LAST_ROUTES_FILE = "jax_routes_last.npz"
# The archs whose prefill and decode logits are held whole against
# repro's (LAST_LOGITS) and whose every gradient is (LAST_GRADS).  The
# recurrent families are chaotic at random init (ssm_pair's doc: repro
# jitted and op by op 0.189 apart at the reduced zamba2's logits), and
# the mesh's bf16 partial sums round otherwise than one process: zamba2's
# logits (0.23 from repro's) and both families' gradients (the reduced
# zamba2's grad norm 1.0 % from one process's, which is 0.2 % from
# repro's; single leaves up to 24 %) are held block by block against one
# process instead (LAST_BLOCKS), their loss and ce against repro.
LAST_LOGITS = ("deepseek-v2-236b", "xlstm-1.3b")
LAST_GRADS = ("deepseek-v2-236b",)
# Blocks held on each rank against one process in f32 (no cast: the
# split's arithmetic, not bf16 rounding; zamba2's shared block casts its
# input to bf16 itself): the output rows and each rank's block of every
# leaf's gradient, among them the two traps (a re-blocked leaf, wuq /
# in_proj, whose gather slices its gradient instead of reduce-scattering
# it; a split norm whose sum passes its gradient through psum_fwd alone)
# and the whole leaves a rank reads in part (conv_w / conv_b, a_log,
# d_skip, dt_bias, the norms' scales, the mLSTM's wi / wf, the sLSTM's
# r{z,i,f,o} and its wo); and one decode step's output and new state.
# (arch, the blocks' parameter prefixes, kind.)
LAST_BLOCKS = (("deepseek-v2-236b", ("blocks.0.attn",), "mla"),
               ("deepseek-v2-236b", ("blocks.0.moe.shared",), "shared_ffn"),
               ("zamba2-1.2b", ("groups.0.mambas.0",), "mamba2"),
               ("zamba2-1.2b", ("shared", "groups.1.lora"), "shared_attn"),
               ("xlstm-1.3b", ("groups.0.mlstms.0",), "mlstm"),
               ("xlstm-1.3b", ("groups.1.slstm",), "slstm"))
# The tensor-parallel trees: the two train archs, a reduced MiniCPM
# whose vocab (513) the rules leave whole (its 6 heads are whole on a
# 4-way axis too; its FFN of 180 splits), the reduced vlm (q heads split,
# its 2 kv heads whole) and the reduced encdec with a vocab the axis
# does not divide, as SeamlessM4T's 256,206 (its blocks split, its head
# whole).
TREE_CASES = {"qwen1.5-0.5b": {}, "mixtral-8x7b": {},
              "minicpm-2b": {"vocab": 513}, "llama-3.2-vision-90b": {},
              "seamless-m4t-medium": {"vocab": 513},
              **{a: {} for a in LAST_ARCHS}}
# The cross-attention families (reduced) on (2, 4): prefill, DECODE_STEPS
# of the serve loop and one train step with remat "full", against repro
# under the same mesh; the prefill on the (8,) data mesh against one
# process.  The vlm's 2 kv heads stay whole on the 4-way axis (each rank
# computes both and reads the one its q head uses), the encdec's 4 split.
# Both gates of each vlm cross block are drawn from U(0.5, 1.5) (repro
# starts them at zero, which hides the image path); the encoder's frames
# are XATTN_ENC_S long, another length than the tokens.
XATTN_ARCHS = ("llama-3.2-vision-90b", "seamless-m4t-medium")
XATTN_ENC_S = 40
XATTN_KNOBS = dict(RUN_KNOBS, remat="full")
VOCAB_CE = (8, 6, 512)        # vocab-parallel CE: rows, positions, vocab
# The dry-run (``launch.dryrun``) on (2, 4) at TRAIN_B x TRAIN_S with
# RUN_KNOBS.  The gloo ranks step DRYRUN_GLOO_ARCHS' cells with real
# weights, unforced, their collectives, FLOPs and argument bytes counted
# (``_dryrun_rank``); repro's ``run_cell`` on the reduced configs
# (``jax_dryrun``): the train cells of the dense and MoE families in the
# first JAX child, every arch's prefill and decode in the second.
DRYRUN_KINDS = ("train", "prefill", "decode")
DRYRUN_ARCHS = ("yi-9b", "qwen1.5-0.5b", "nemotron-4-15b", "minicpm-2b",
                "llama-3.2-vision-90b", "seamless-m4t-medium",
                "zamba2-1.2b", "xlstm-1.3b", "deepseek-v2-236b",
                "mixtral-8x7b")
DRYRUN_TRAIN_ARCHS = ("yi-9b", "qwen1.5-0.5b", "nemotron-4-15b",
                      "minicpm-2b", "deepseek-v2-236b", "mixtral-8x7b")
DRYRUN_GLOO_ARCHS = TRAIN_ARCHS
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter")
# The sequence-parallel residual (``layers.seq_parallel``) block by block
# on (2, 4), TRAIN_B x TRAIN_S (S / 4 = 8 tokens a rank) and SP_ODD_S
# (30: the 4-way axis does not divide it, the residual stays whole): each
# layer-0 block of the pinned families, (arch, kind, its parameter
# prefixes), against the same block with the residual whole
# (``whole_residual``: the layout before the sequence-parallel one) and
# against one process on the rank's rows.  MiniCPM (reduced) splits none
# of its 6 q heads on the 4-way axis; its weights are drawn here
# (SP_SEED), the others' are repro's.  The kinds in SP_BIT_EQUAL change
# only a collective (an all-reduce becomes a reduce-scatter, the input
# all-gathered), the others also project k / v, MLA's latents, zamba2's
# LoRA or undivided heads on the rank's own rows.  Gradients (SP_GRADS:
# all but the MoE blocks, whose capacity is per data shard) in f32
# (``f32_blocks``) against one process on the whole batch.
SP_BLOCKS = (("qwen1.5-0.5b", "dense", ("blocks.0",)),
             ("minicpm-2b", "dense", ("blocks.0",)),
             ("mixtral-8x7b", "moe", ("blocks.0",)),
             ("deepseek-v2-236b", "moe", ("blocks.0",)),
             ("deepseek-v2-236b", "mla", ("blocks.0.attn",)),
             ("llama-3.2-vision-90b", "dense", ("groups.0.selfs.0",)),
             ("llama-3.2-vision-90b", "cross", ("groups.0.cross",)),
             ("seamless-m4t-medium", "encoder", ("enc_blocks.0",)),
             ("zamba2-1.2b", "shared", ("shared", "groups.0.lora")))
SP_BIT_EQUAL = (("qwen1.5-0.5b", "dense"), ("llama-3.2-vision-90b", "cross"),
                ("seamless-m4t-medium", "encoder"))
SP_GRADS = tuple(c for c in SP_BLOCKS if c[1] != "moe")
SP_ODD_S = 30
SP_SEED = 11
# The per-block gathers (``runtime.steps.PerBlock``) on a (2, 2) mesh of
# the 4-rank spawn, each family's reduced cell on its weights above:
# the steps from this rank's blocks against the whole compute tree
# gathered before the forward (``_compute_tree`` bound), bit for bit:
# prefill logits, DECODE_STEPS serve steps' logits and caches, and a
# train step's metrics and every leaf's gradient under each remat of
# PER_BLOCK_REMATS; and, by weakrefs on the gathered leaves, that no rank
# holds two stacked blocks' at once.
PER_BLOCK_MESH = (2, 2)
PER_BLOCK_ARCHS = ("qwen1.5-0.5b", "deepseek-v2-236b", "llama-3.2-vision-90b",
                   "seamless-m4t-medium", "zamba2-1.2b", "xlstm-1.3b")
PER_BLOCK_REMATS = ("full", "dots", "none")
# The MoE families (reduced) on the (8,) data mesh, where each rank runs
# the experts on its slice of one global capacity plan's slots: the
# prefill (and, where True, DECODE_STEPS decode steps, whose capacity of
# 5 slots an expert is below the 8 ranks) against one process's forward
# (and decode loop) of the whole batch: last-position logits, and each
# MoE call's routes, dropped pairs and load-balance loss, bit for bit.
DATA_MOE_ARCHS = {"mixtral-8x7b": True, "deepseek-v2-236b": False}
# Mixtral's routing in repro's train step, written by the JAX child
# beside its outputs and read by the port's ranks.
ROUTES_FILE = "jax_routes.npz"
LOOP_STEPS, LOOP_EVERY, LOOP_FAIL = 3, 2, 2


class ArraySource:
    """``batch_at(step)`` over fixed global batches (numpy), turned into
    arrays by ``as_array``."""

    def __init__(self, tokens, labels, as_array):
        self.tokens, self.labels, self.as_array = tokens, labels, as_array

    def batch_at(self, step: int) -> dict:
        return {"tokens": self.as_array(self.tokens[step]),
                "labels": self.as_array(self.labels[step])}


@contextlib.contextmanager
def routes(force=None):
    """The port's router calls inside the block, in order ([T, k] ids,
    recorded); with ``force`` (another run's calls, one a layer), each
    call routes as that run's did, weighted by this run's probabilities
    at those ids (renormalized, as the router does), its load-balance
    counts those ids'.  A layer is known by its router weight's bits (a
    step that gathers block by block hands each call a new tensor of the
    same bits), so a remat backward's recomputation routes as its forward
    did."""
    import torch

    from repro_torch.models import moe
    calls, real, layer = [], moe._router, {}

    def rec(params, cfg, x2d):
        out = real(params, cfg, x2d)
        calls.append(out[1].detach().clone())
        if force is None:
            return out
        w = params["router"]["w"].detach()
        key = (w.dtype, w.float().numpy().tobytes())
        ids = force[layer.setdefault(key, len(layer))]
        probs = torch.softmax(x2d.float() @ params["router"]["w"].float(),
                              dim=-1)
        p = probs.gather(1, ids.long())
        ce = torch.bincount(ids.reshape(-1).long(), minlength=cfg.n_experts
                            ).float() / ids.numel()
        return p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-9), ids, \
            (out[2][0], ce)
    moe._router = rec
    try:
        yield calls
    finally:
        moe._router = real


@contextlib.contextmanager
def moe_aux():
    """Each ``moe_ffn`` call's output rows and aux inside the block, in
    order: {"y": [...], "dropped": [...], "lb_loss": [...]}."""
    from repro_torch.models import transformer
    calls = {"y": [], "dropped": [], "lb_loss": []}
    real = transformer.moe_ffn

    def rec(*args, **kwargs):
        y, aux = real(*args, **kwargs)
        for k, v in dict(aux, y=y).items():
            calls[k].append(v.detach().clone())
        return y, aux
    transformer.moe_ffn = rec
    try:
        yield calls
    finally:
        transformer.moe_ffn = real


@contextlib.contextmanager
def partials():
    """The port's row-parallel products inside the block, in call order:
    [tag ("wo" or "w_down"), this rank's input columns, its weight block,
    the partial it sums over "model" (bf16 values, handed to the sum in
    f32; an all-reduce, or a reduce-scatter along the sequence)]."""
    from repro_torch.models import attention, ffn, layers
    calls = []
    real_rows, real_psum = layers.dense_rows, layers.psum_fwd

    real_scatter = layers.scatter_fwd

    def rows_for(tag):
        def rec(params, x, mesh, sp=False):
            calls.append([tag, x.clone(), params["w"]])
            return real_rows(params, x, mesh, sp)
        return rec

    def keep(x):
        if calls and len(calls[-1]) == 3:
            calls[-1].append(x.clone())

    def psum(x, mesh, axes):
        keep(x)
        return real_psum(x, mesh, axes)

    def scatter(x, mesh, axes, dim):
        keep(x)
        return real_scatter(x, mesh, axes, dim)
    attention.dense_rows, ffn.dense_rows = rows_for("wo"), rows_for("w_down")
    layers.psum_fwd, layers.scatter_fwd = psum, scatter
    try:
        yield calls
    finally:
        attention.dense_rows = ffn.dense_rows = real_rows
        layers.psum_fwd, layers.scatter_fwd = real_psum, real_scatter


@contextlib.contextmanager
def whole_residual():
    """The blocks with the residual whole over "model" whatever its
    length (``layers.seq_parallel`` False): the tensor-parallel layout
    the sequence-parallel one replaced."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    real = layers.seq_parallel
    layers.seq_parallel = tf.seq_parallel = lambda mesh, s: False
    try:
        yield
    finally:
        layers.seq_parallel = tf.seq_parallel = real


@contextlib.contextmanager
def f32_blocks():
    """The blocks' activations in f32 (``ACT_DTYPE``): the split's
    arithmetic without bf16 rounding."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    layers.ACT_DTYPE = tf.ACT_DTYPE = torch.float32
    try:
        yield
    finally:
        layers.ACT_DTYPE = tf.ACT_DTYPE = torch.bfloat16


def flat(tree, pre=()) -> dict:
    """{"a/b/c": leaf} of a nested dict (repro's path keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + (k,)))
        else:
            out["/".join(pre + (k,))] = v
    return out


def nest(flat_tree: dict) -> dict:
    out: dict = {}
    for key, v in flat_tree.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def moe_cfg(configs_mod, n_experts):
    return dataclasses.replace(configs_mod.get_reduced_config("mixtral-8x7b"),
                               n_experts=n_experts,
                               capacity_factor=MOE_CAPACITY)


def moe_inputs(cfg, b, seed=1):
    """x [b, MOE_SEQ, d] (bf16 values as f32) and an f32 cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, MOE_SEQ, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=(b, MOE_SEQ, cfg.d_model)).astype(np.float32)
    return x, cot


def train_batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    return toks[:, :-1].copy(), toks[:, 1:].copy()


def xattn_batch(ref, arch, as_array, labels=True) -> dict:
    """A cross-attention arch's global batch from ``ref``: tokens (and
    labels) and its stub, ``img`` or ``frames``."""
    pre = f"in/{arch}/"
    return {k[len(pre):]: as_array(v) for k, v in ref.items()
            if k.startswith(pre) and (labels or k != pre + "labels")}


@contextlib.contextmanager
def vma_unchecked():
    """``repro``'s MoE ``shard_map`` with ``check_vma=False`` (a patch of
    the module's name in this process; no file changes).  Forward values
    are the same; the gradient is then the derivative of that forward,
    which with a batch split over "data" (``check_vma=True`` in
    ``repro``) it is not on the router's path (ROADMAP §3, F9)."""
    from repro.models import moe as j_moe
    orig = j_moe.shard_map
    j_moe.shard_map = lambda *a, **k: orig(*a, **{**k, "check_vma": False})
    try:
        yield
    finally:
        j_moe.shard_map = orig


@contextlib.contextmanager
def jax_moe_inputs():
    """``repro``'s MoE layers' inputs inside the block, as (x [B, S, D],
    router weight) f32 numpy pairs in completion order (a
    ``jax.debug.callback`` in front of each ``moe_ffn`` call: it reads
    the values and changes none; call ``jax.effects_barrier()`` before
    reading them)."""
    import jax

    from repro.models import transformer as j_tf
    seen, real = [], j_tf.moe_ffn

    def keep(x, w):
        seen.append((np.asarray(x).astype(np.float32),
                     np.asarray(w).astype(np.float32)))

    def rec(p, cfg, x, mesh=None):
        jax.debug.callback(keep, x, p["router"]["w"])
        return real(p, cfg, x, mesh=mesh)
    j_tf.moe_ffn = rec
    try:
        yield seen
    finally:
        j_tf.moe_ffn = real


def jax_routes(cfg, router_ws, seen, n_data, dtype="bfloat16"):
    """[(ids [B * S, k], the k-th minus (k+1)-th probability [B * S])]
    a MoE layer: ``repro``'s router (``moe._router``) on each data
    shard's rows of that layer's input (the seen call whose router weight
    is the layer's, ``router_ws[layer]``, as the step cast it: to
    ``dtype``, bf16 in a train step, f32 in the serving steps)."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as j_moe
    out = []
    for w in router_ws:
        x = next(a for a, sw in seen if np.array_equal(sw, w))
        ids, gaps = [], []
        for rows in np.split(x, n_data):
            x2d = jnp.asarray(rows.reshape(-1, x.shape[-1]), jnp.bfloat16)
            _, top_i, _ = j_moe._router({"router": {"w": jnp.asarray(
                w, dtype)}}, cfg, x2d)
            probs = np.sort(np.asarray(jax.nn.softmax(
                x2d.astype(jnp.float32) @ jnp.asarray(w), axis=-1)), -1)
            ids.append(np.asarray(top_i, np.int32))
            gaps.append(probs[:, -cfg.top_k] - probs[:, -cfg.top_k - 1])
        out.append((np.concatenate(ids), np.concatenate(gaps)))
    return out


def make_inputs(path: str) -> None:
    """The weights (``repro``'s ``init_params``, keys 0 and 3) and inputs
    of every case, to ``path``."""
    import jax

    from repro import configs
    from repro.models import moe as j_moe
    from repro.models.model import build_model
    from repro.models.module import init_params
    out = {}
    for name, (e, b) in MOE_CASES.items():
        cfg = moe_cfg(configs, e)
        params = init_params(j_moe.moe_spec(cfg), jax.random.key(3))
        for k, v in flat(params).items():
            out[f"w/moe_{name}/{k}"] = np.asarray(v)
        out[f"in/moe_{name}/x"], out[f"in/moe_{name}/cot"] = \
            moe_inputs(cfg, b)
    for arch in TRAIN_ARCHS:
        cfg = configs.get_reduced_config(arch)
        params = init_params(build_model(cfg).specs, jax.random.key(0))
        for k, v in flat(params).items():
            out[f"w/{arch}/{k}"] = np.asarray(v)
        out[f"in/{arch}/tokens"], out[f"in/{arch}/labels"] = \
            train_batch(cfg)
        loop = [train_batch(cfg, seed=10 + i) for i in range(LOOP_STEPS)]
        out[f"in/{arch}/loop_tokens"] = np.stack([t for t, _ in loop])
        out[f"in/{arch}/loop_labels"] = np.stack([lb for _, lb in loop])
        # Gradients for AdamW on equal inputs.
        rng = np.random.default_rng(2)
        for k, v in flat(params).items():
            out[f"in/{arch}/grads/{k}"] = (rng.normal(size=v.shape) * 0.01
                                           ).astype(np.float32)
    for arch in XATTN_ARCHS:
        cfg = configs.get_reduced_config(arch)
        params = init_params(build_model(cfg).specs, jax.random.key(0))
        rng = np.random.default_rng(1)
        for k, v in flat(params).items():
            v = np.asarray(v)
            if k.endswith(("cross/gate", "cross/ffn_gate")):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            out[f"w/{arch}/{k}"] = v
        out[f"in/{arch}/tokens"], out[f"in/{arch}/labels"] = \
            train_batch(cfg, seed=3)
        if cfg.family == "vlm":
            out[f"in/{arch}/img"] = rng.normal(size=(
                TRAIN_B, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)
        else:
            out[f"in/{arch}/frames"] = rng.normal(size=(
                TRAIN_B, XATTN_ENC_S, cfg.d_model)).astype(np.float32)
    for arch in LAST_ARCHS:
        cfg = configs.get_reduced_config(arch)
        params = init_params(build_model(cfg).specs, jax.random.key(0))
        rng = np.random.default_rng(6)
        for k, v in flat(params).items():
            v, leaf = np.asarray(v), k.rsplit("/", 1)[-1]
            if leaf in ("a_log", "dt_bias"):
                v = rng.uniform(-1, 1, v.shape).astype(np.float32)
            elif leaf == "b_q":
                v = (rng.normal(size=v.shape) / 10).astype(np.float32)
            out[f"w/{arch}/{k}"] = v
        out[f"in/{arch}/tokens"], out[f"in/{arch}/labels"] = \
            train_batch(cfg, seed=4)
    np.savez(path, **out)


def last_run(arch, run_config):
    """The run knobs of a LAST_ARCHS case."""
    return run_config(**dict(XATTN_KNOBS, remat=LAST_REMAT[arch],
                             ssm_chunk=LAST_CHUNK))


def jax_reference_last(ref, mesh, out, out_dir) -> None:
    """The LAST_ARCHS cases through ``repro`` on ``mesh``, jitted: the
    train step's loss function's metrics (``vma_unchecked``, as the other
    train steps) and its lr at OPT_STEP0, for LAST_GRADS its gradients
    (their global norm is the step's grad norm), for LAST_LOGITS the
    prefill step and DECODE_STEPS of ``decode_step``; DeepSeek-V2's
    routing of every call (``jax_routes``) handed to the port's ranks in
    LAST_ROUTES_FILE."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.configs.base import RunConfig
    from repro.launch.mesh import use_mesh
    from repro.models.model import build_model
    from repro.optim import adamw
    from repro.runtime import steps
    from repro.sharding.rules import param_shardings
    routes = {}
    for arch in LAST_ARCHS:
        cfg = configs.get_reduced_config(arch)
        model = build_model(cfg)
        run = last_run(arch, RunConfig)
        pre = f"w/{arch}/"
        raw = nest({k[len(pre):]: jnp.asarray(v) for k, v in ref.items()
                    if k.startswith(pre)})
        batch = {k: jnp.asarray(ref[f"in/{arch}/{k}"])
                 for k in ("tokens", "labels")}
        toks = batch["tokens"]
        loss_fn = steps.make_loss_fn(model, run, mesh)
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

        def routed(tag, dtype):
            """The routes of the MoE calls seen since the last tag."""
            jax.effects_barrier()
            if not cfg.n_experts:
                return
            new = seen[routed.at:]
            routed.at = len(seen)
            ws = np.asarray(raw["blocks"]["moe"]["router"]["w"]).astype(
                dtype).astype(np.float32)
            for i, (ids, gap) in enumerate(jax_routes(
                    cfg, list(ws), new, MESH[0], dtype)):
                routes[f"{arch}/{tag}/ids{i}"] = ids
                routes[f"{arch}/{tag}/gap{i}"] = gap
        routed.at = 0
        with use_mesh(mesh), vma_unchecked(), jax_moe_inputs() as seen:
            params = jax.device_put(raw, param_shardings(model.specs, mesh))
            if arch in LAST_GRADS:
                (_, metrics), grads = jax.jit(grad_fn)(params, batch)
            else:
                _, metrics = jax.jit(loss_fn)(params, batch)
            routed("train", jnp.bfloat16)
            if arch in LAST_LOGITS:
                out[f"{arch}/prefill"] = np.asarray(jax.jit(
                    steps.make_prefill_step(model, run, mesh))(
                        params, {"tokens": toks}))
                routed("prefill", np.float32)
                dec = jax.jit(lambda p, t, c: model.decode_step(
                    p, run, t, c, mesh=mesh))
                cache = model.init_cache(TRAIN_B, DECODE_LEN)
                for t in range(DECODE_STEPS):
                    logits, cache = dec(params, toks[:, t:t + 1], cache)
                    out[f"{arch}/decode{t}"] = np.asarray(logits[:, -1],
                                                          np.float32)
                    routed(f"decode{t}", np.float32)
        if cfg.n_experts:
            part = os.path.join(out_dir, "routes_last.part.npz")
            np.savez(part, **routes)
            os.replace(part, os.path.join(out_dir, LAST_ROUTES_FILE))
            out.update({k: v for k, v in routes.items() if "/train/" in k})
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}"] = np.asarray(v, np.float32)
        out[f"{arch}/lr"] = np.asarray(adamw.schedule(run, jnp.int32(
            OPT_STEP0)), np.float32)
        if arch in LAST_GRADS:
            for k, v in flat(grads).items():
                out[f"{arch}/g/{k}"] = np.asarray(v, np.float32)


def dryrun_shape(kind: str, shape_cls):
    """The dry-run's reduced cell of ``kind`` (``shape_cls``: either
    package's ``ShapeConfig``)."""
    return shape_cls(f"reduced_{kind}", TRAIN_S, TRAIN_B, kind)


def jax_dryrun(mesh, cells, out: dict) -> None:
    """``repro``'s ``launch.dryrun.run_cell`` of each (arch, kind) of
    ``cells`` on ``mesh``, its ``get_config`` replaced by
    ``get_reduced_config``: "dryrun/{arch}/{kind}/{field}".  The module
    is imported here, after jax made its 8 devices (it sets XLA_FLAGS at
    import)."""
    import repro.launch.dryrun as jd
    from repro import configs
    from repro.configs.base import RunConfig, ShapeConfig
    jd.get_config = configs.get_reduced_config
    for arch, kind in cells:
        rec = jd.run_cell(arch, dryrun_shape(kind, ShapeConfig), mesh,
                          RunConfig(**RUN_KNOBS), verbose=False)
        pre = f"dryrun/{arch}/{kind}/"
        for key in ("params", "param_bytes", "flops_per_device"):
            out[pre + key] = np.int64(rec[key])
        for key, v in rec["memory"].items():
            out[pre + key] = np.int64(v)


def jax_reference(inputs: str, out_file: str) -> None:
    """Every case through ``repro`` on the (2, 4) mesh, jitted, with
    ``backend="ref"`` kernels (none of the cases reaches a Pallas kernel:
    ``repro``'s attention is ``blockwise_attn``).  ``moe_ffn``'s gradients
    both as ``repro`` computes them ("g_vma") and under
    ``vma_unchecked`` ("g"); the train steps under ``vma_unchecked``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.configs.base import RunConfig
    from repro.launch.mesh import make_test_mesh, use_mesh
    from repro.models import moe as j_moe
    from repro.models.model import build_model
    from repro.optim import adamw
    from repro.runtime import steps
    from repro.sharding.rules import param_shardings, spec_pspec

    assert jax.device_count() == 8, jax.devices()
    mesh = make_test_mesh(MESH)
    ranks = [d.id for d in mesh.devices.flat]
    with np.load(inputs) as z:
        ref = {k: z[k] for k in z.files}
    out = {}
    run = RunConfig(**RUN_KNOBS)

    def put(tree, sh):
        return jax.device_put(tree, sh)

    def weights(tag):
        pre = f"w/{tag}/"
        return nest({k[len(pre):]: jnp.asarray(v) for k, v in ref.items()
                     if k.startswith(pre)})

    # -- one train step -------------------------------------------------
    # Mixtral first: its routing is handed to the port's ranks as soon as
    # it is known (ROUTES_FILE), while this child goes on.
    for arch in sorted(TRAIN_ARCHS, key=lambda a: a != TRAIN_ARCHS[1]):
        cfg = configs.get_reduced_config(arch)
        model = build_model(cfg)
        params = weights(arch)
        batch = {"tokens": jnp.asarray(ref[f"in/{arch}/tokens"]),
                 "labels": jnp.asarray(ref[f"in/{arch}/labels"])}
        p_sh = param_shardings(model.specs, mesh)
        # Each device's block of every leaf (rank = position in the mesh).
        for k, p in flat(model.specs).items():
            idx = NamedSharding(mesh, spec_pspec(p, mesh)) \
                .devices_indices_map(p.shape)
            dev = {d.id: s for d, s in idx.items()}
            out[f"{arch}/blocks/{k}"] = np.array(
                [[[sl.start or 0, p.shape[i] if sl.stop is None else sl.stop]
                  for i, sl in enumerate(dev[r])] for r in ranks])
        grad_fn = jax.value_and_grad(steps.make_loss_fn(model, run, mesh),
                                     has_aux=True)
        train_step = steps.make_train_step(model, run, mesh)

        def both(p, o, bt):
            (_, metrics), grads = grad_fn(p, bt)
            return (metrics, grads) + tuple(train_step(p, o, bt))

        with use_mesh(mesh), vma_unchecked(), jax_moe_inputs() as seen:
            params_s = put(params, p_sh)
            opt = adamw.init(params_s)._replace(step=jnp.int32(OPT_STEP0))
            metrics, grads, p2, o2, m2 = jax.jit(both)(params_s, opt, batch)
            jax.effects_barrier()
        if cfg.n_experts:
            # How repro routed each MoE layer (the router weight as the
            # step cast it: bf16).
            ws = np.asarray(params["blocks"]["moe"]["router"]["w"]).astype(
                jnp.bfloat16).astype(np.float32)
            for i, (ids, gap) in enumerate(jax_routes(
                    cfg, list(ws), seen, MESH[0])):
                out[f"{arch}/routes/ids{i}"] = ids
                out[f"{arch}/routes/gap{i}"] = gap
            part = os.path.join(os.path.dirname(out_file), "routes.part.npz")
            np.savez(part, **{k: v for k, v in out.items()
                              if "/routes/" in k})
            os.replace(part, os.path.join(os.path.dirname(out_file),
                                          ROUTES_FILE))
        # AdamW alone on the input gradients, under the mesh.
        pre = f"in/{arch}/grads/"
        g_in = nest({k[len(pre):]: jnp.asarray(v) for k, v in ref.items()
                     if k.startswith(pre)})
        with use_mesh(mesh):
            upd_p, _, upd_gn = jax.jit(lambda g, o, p: adamw.update(
                g, o, p, run, adamw.schedule(run, o.step)))(
                    put(g_in, p_sh), opt, params_s)
        out[f"{arch}/upd/grad_norm"] = np.asarray(upd_gn)
        for k, v in flat(upd_p).items():
            out[f"{arch}/upd/{k}"] = np.asarray(v, np.float32)
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}"] = np.asarray(v, np.float32)
        for k, v in m2.items():
            out[f"{arch}/step/{k}"] = np.asarray(v, np.float32)
        for tag, tree in (("g", grads), ("p2", p2), ("m2", o2.m),
                          ("v2", o2.v)):
            for k, v in flat(tree).items():
                out[f"{arch}/{tag}/{k}"] = np.asarray(v, np.float32)
    # -- moe_ffn --------------------------------------------------------
    for name, (e, b) in MOE_CASES.items():
        cfg = moe_cfg(configs, e)
        spec = j_moe.moe_spec(cfg)
        params = weights(f"moe_{name}")
        cot = ref[f"in/moe_{name}/cot"]
        xb = jnp.asarray(ref[f"in/moe_{name}/x"]).astype(jnp.bfloat16)

        def obj(p, xx):
            y, aux = j_moe.moe_ffn(p, cfg, xx, mesh)
            return (jnp.sum(y.astype(jnp.float32) * cot)
                    + LB_COEF * aux["lb_loss"]), (y, aux)

        for tag, ctx in (("g_vma", contextlib.nullcontext),
                         ("g", vma_unchecked)):
            with use_mesh(mesh), ctx():
                p_s = put(params, param_shardings(spec, mesh))
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    obj, argnums=(0, 1), has_aux=True))(p_s, xb)
            out[f"moe_{name}/y"] = np.asarray(y.astype(jnp.float32))
            out[f"moe_{name}/lb"] = np.asarray(aux["lb_loss"])
            out[f"moe_{name}/dropped"] = np.asarray(aux["dropped"])
            out[f"moe_{name}/{tag}/x"] = np.asarray(gx.astype(jnp.float32))
            for k, v in flat(gp).items():
                out[f"moe_{name}/{tag}/{k}"] = np.asarray(v, np.float32)
    jax_dryrun(mesh, [(a, "train") for a in DRYRUN_TRAIN_ARCHS], out)

    np.savez(out_file, **out)
    print("jax reference done")


def jax_reference_steps(inputs: str, out_file: str, tmp: str) -> None:
    """The serving steps and the other training entry points through
    ``repro`` on 8 fake devices, jitted (a second child beside
    ``jax_reference``): ``make_prefill_step`` and DECODE_STEPS of
    ``decode_step`` / ``make_serve_step`` on (2, 4); a train step on the
    (8,) ("data",) mesh and one with 2 microbatches on (2, 4) (mixtral);
    ``train_loop`` on (2, 4) with a failure at LOOP_FAIL (qwen)."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.configs.base import RunConfig
    from repro.launch.mesh import make_mesh, make_test_mesh, use_mesh
    from repro.models.model import build_model
    from repro.optim import adamw
    from repro.runtime import steps
    from repro.runtime.driver import DriverConfig, train_loop
    from repro.sharding.rules import param_shardings

    assert jax.device_count() == 8, jax.devices()
    with np.load(inputs) as z:
        ref = {k: z[k] for k in z.files}
    mesh = make_test_mesh(MESH)
    out = {}
    run = RunConfig(**RUN_KNOBS)

    def weights(tag):
        pre = f"w/{tag}/"
        return nest({k[len(pre):]: jnp.asarray(v) for k, v in ref.items()
                     if k.startswith(pre)})

    jax_reference_last(ref, mesh, out, tmp)
    for arch in TRAIN_ARCHS:
        cfg = configs.get_reduced_config(arch)
        model = build_model(cfg)
        toks = jnp.asarray(ref[f"in/{arch}/tokens"])
        with use_mesh(mesh):
            params = jax.device_put(weights(arch),
                                    param_shardings(model.specs, mesh))
            out[f"{arch}/prefill"] = np.asarray(jax.jit(
                steps.make_prefill_step(model, run, mesh))(
                    params, {"tokens": toks}))
            dec = jax.jit(lambda p, t, c: model.decode_step(p, run, t, c,
                                                            mesh=mesh))
            serve = jax.jit(steps.make_serve_step(model, run, mesh))
            cache = model.init_cache(TRAIN_B, DECODE_LEN)
            cache2 = model.init_cache(TRAIN_B, DECODE_LEN)
            for t in range(DECODE_STEPS):
                logits, cache = dec(params, toks[:, t:t + 1], cache)
                nxt, cache2 = serve(params, toks[:, t:t + 1], cache2)
                out[f"{arch}/decode{t}"] = np.asarray(logits[:, -1],
                                                      np.float32)
                out[f"{arch}/serve{t}"] = np.asarray(nxt)
    arch = TRAIN_ARCHS[1]
    cfg = configs.get_reduced_config(arch)
    model = build_model(cfg)
    batch = {"tokens": jnp.asarray(ref[f"in/{arch}/tokens"]),
             "labels": jnp.asarray(ref[f"in/{arch}/labels"])}
    dmesh = make_mesh(DATA_MESH, ("data",))
    for tag, m, r in (("data_mesh", dmesh, run),
                      ("microbatch", mesh, RunConfig(**RUN_KNOBS,
                                                     microbatch=2))):
        grad_fn = jax.value_and_grad(steps.make_loss_fn(model, r, m),
                                     has_aux=True)
        train_step = steps.make_train_step(model, r, m)

        def both(p, o, bt):
            (_, metrics), grads = grad_fn(p, bt)
            return (metrics, grads) + tuple(train_step(p, o, bt))

        with use_mesh(m), vma_unchecked():
            p = jax.device_put(weights(arch), param_shardings(model.specs, m))
            o = adamw.init(p)._replace(step=jnp.int32(OPT_STEP0))
            _, grads, _, _, m2 = jax.jit(both)(p, o, batch)
        for k, v in m2.items():
            out[f"{tag}/step/{k}"] = np.asarray(v, np.float32)
        if tag == "data_mesh":
            for k, v in flat(grads).items():
                out[f"{tag}/g/{k}"] = np.asarray(v, np.float32)
    arch = TRAIN_ARCHS[0]
    model = build_model(configs.get_reduced_config(arch))
    src = ArraySource(ref[f"in/{arch}/loop_tokens"],
                      ref[f"in/{arch}/loop_labels"], jnp.asarray)
    dcfg = DriverConfig(total_steps=LOOP_STEPS, ckpt_every=LOOP_EVERY,
                        ckpt_dir=os.path.join(tmp, "jax_loop"))
    with use_mesh(mesh), vma_unchecked():
        p = jax.device_put(weights(arch), param_shardings(model.specs, mesh))
        p, _, hist = train_loop(jax.jit(steps.make_train_step(model, run,
                                                              mesh)),
                                p, adamw.init(p), src, dcfg,
                                fail_at={LOOP_FAIL}, log=lambda *_: None)
    out["loop/loss"] = np.asarray(hist["loss"], np.float32)
    out["loop/restarts"] = np.asarray(hist["restarts"])
    for k, v in flat(p).items():
        out[f"loop/p/{k}"] = np.asarray(v, np.float32)
    # The cross-attention families: prefill, decode / serve, a train step
    # with remat "full".
    xrun = RunConfig(**XATTN_KNOBS)
    for arch in XATTN_ARCHS:
        model = build_model(configs.get_reduced_config(arch))
        batch = xattn_batch(ref, arch, jnp.asarray)
        toks = batch["tokens"]
        grad_fn = jax.value_and_grad(steps.make_loss_fn(model, xrun, mesh),
                                     has_aux=True)
        train_step = steps.make_train_step(model, xrun, mesh)

        def both(p, o, bt):
            (_, metrics), grads = grad_fn(p, bt)
            return (metrics, grads) + tuple(train_step(p, o, bt))

        with use_mesh(mesh):
            params = jax.device_put(weights(arch),
                                    param_shardings(model.specs, mesh))
            out[f"{arch}/prefill"] = np.asarray(jax.jit(
                steps.make_prefill_step(model, xrun, mesh))(
                    params, {k: v for k, v in batch.items()
                             if k != "labels"}))
            dec = jax.jit(lambda p, t, c: model.decode_step(p, xrun, t, c,
                                                            mesh=mesh))
            serve = jax.jit(steps.make_serve_step(model, xrun, mesh))
            cache = model.init_cache(TRAIN_B, DECODE_LEN)
            cache2 = model.init_cache(TRAIN_B, DECODE_LEN)
            for t in range(DECODE_STEPS):
                logits, cache = dec(params, toks[:, t:t + 1], cache)
                nxt, cache2 = serve(params, toks[:, t:t + 1], cache2)
                out[f"{arch}/decode{t}"] = np.asarray(logits[:, -1],
                                                      np.float32)
                out[f"{arch}/serve{t}"] = np.asarray(nxt)
            o = adamw.init(params)._replace(step=jnp.int32(OPT_STEP0))
            metrics, grads, _, _, m2 = jax.jit(both)(params, o, batch)
        # The same gradients on one device (no mesh): repro's own spread
        # between two layouts.
        (_, _), g_one = jax.jit(jax.value_and_grad(
            steps.make_loss_fn(model, xrun), has_aux=True))(weights(arch),
                                                            batch)
        for k, v in flat(g_one).items():
            out[f"{arch}/g_one/{k}"] = np.asarray(v, np.float32)
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}"] = np.asarray(v, np.float32)
        for k, v in m2.items():
            out[f"{arch}/step/{k}"] = np.asarray(v, np.float32)
        for k, v in flat(grads).items():
            out[f"{arch}/g/{k}"] = np.asarray(v, np.float32)
    jax_dryrun(mesh, [(a, k) for a in DRYRUN_ARCHS
                      for k in ("prefill", "decode")], out)
    np.savez(out_file, **out)
    print("jax reference done")


# ------------------------------------------------------------- the port
def port_model(arch, ref, device="cpu", trainable=True):
    """The port's full model carrying ``repro``'s weights from ``ref``."""
    from repro_torch import configs
    from repro_torch.models import module
    from repro_torch.models.model import build_model
    cfg = configs.get_reduced_config(arch)
    model = build_model(cfg, device, trainable=trainable)
    pre = f"w/{arch}/"
    module.params_from_numpy(model, nest({k[len(pre):]: v
                                          for k, v in ref.items()
                                          if k.startswith(pre)}))
    return model


def _moe_rank(mesh, ref, out):
    """moe_ffn on this rank: the objective's share and gradients, the
    outputs and gradients gathered whole (``out`` on rank 0)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.runtime.steps import _compute_tree
    from repro_torch.models.module import flatten
    from repro_torch.sharding.rules import (NamedSharding, gather_full,
                                            gather_rows, local_shard,
                                            spec_pspec, split_batch)
    for name, (e, b) in MOE_CASES.items():
        cfg = moe_cfg(configs, e)
        specs = flatten(moe.moe_spec(cfg))
        pre = f"w/moe_{name}/"
        x = torch.from_numpy(ref[f"in/moe_{name}/x"]).to(torch.bfloat16)
        cot = torch.from_numpy(ref[f"in/moe_{name}/cot"])
        view, rows = split_batch(mesh, {"x": x, "cot": cot})
        shard = {k: NamedSharding(mesh, spec_pspec(p, mesh))
                 for k, p in specs.items()}
        local = {k: local_shard(torch.from_numpy(
            ref[pre + k.replace(".", "/")]), shard[k].spec, mesh)
            .clone().requires_grad_(True) for k in specs}
        xr = rows["x"].clone().requires_grad_(True)
        # The router as the train step hands it over (gathered over
        # "data", its gradient summed where the batch is split); the
        # expert weights as placed.
        router = _compute_tree({"router.w": local["router.w"]},
                               {"router.w": shard["router.w"]},
                               view.batch_axes)["router.w"]
        p = {"router": {"w": router}, "w_gate": local["w_gate"],
             "w_up": local["w_up"], "w_down": local["w_down"]}
        y, aux = moe.moe_ffn(p, cfg, xr, view)
        obj = torch.sum(y.float() * rows["cot"]) + LB_COEF * aux["lb_loss"]
        grads = torch.autograd.grad(obj, [xr] + list(local.values()))
        out[f"moe_{name}/y"] = gather_rows(view, y.detach().float()).numpy()
        out[f"moe_{name}/lb"] = aux["lb_loss"].detach().numpy()
        out[f"moe_{name}/dropped"] = aux["dropped"].numpy()
        out[f"moe_{name}/g/x"] = gather_rows(view, grads[0].float()).numpy()
        for k, g in zip(local, grads[1:]):
            out[f"moe_{name}/g/{k.replace('.', '/')}"] = \
                gather_full(g, shard[k]).numpy()


def _train_rank(mesh, ref, out, ckpt_dir, out_dir):
    """One train step of each arch on this rank; each device's block
    slices; the step's update on ``repro``'s own gradients; a checkpoint
    of qwen's state after the step (saved from this mesh)."""
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import build_model
    from repro_torch.models.module import flatten
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (gather_params, model_shardings,
                                            shard_params, shard_slices,
                                            spec_pspec)
    run = RunConfig(**RUN_KNOBS)
    for arch in TRAIN_ARCHS:
        cfg = configs.get_reduced_config(arch)
        full = port_model(arch, ref)
        model = build_model(cfg, "meta", trainable=True)
        sh = model_shardings(model, mesh)
        params = shard_params({k: p.detach()
                               for k, p in full.named_parameters()}, sh)
        for p in params.values():
            p.requires_grad_(True)
        for k, p in flatten(model.specs).items():
            sl = shard_slices(p.shape, spec_pspec(p, mesh), mesh)
            out[f"{arch}/blocks/{k.replace('.', '/')}/rank{mesh.rank}"] = \
                np.array(
                [[s.start or 0, d if s.stop is None else s.stop]
                 for s, d in zip(sl, p.shape)])
        batch = {"tokens": torch.from_numpy(ref[f"in/{arch}/tokens"]),
                 "labels": torch.from_numpy(ref[f"in/{arch}/labels"])}
        force = _repro_routes(out_dir, arch, cfg, mesh)
        with routes(force) as own:
            grads, metrics = steps.make_grad_fn(model, run, mesh)(params,
                                                                  batch)
        for i, ids in enumerate(own):
            out[f"{arch}/own_ids{i}/rank{mesh.rank}"] = ids.numpy()
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}"] = v.numpy()
        for k, g in gather_params(grads, sh).items():
            out[f"{arch}/g/{k}"] = g.numpy()
        opt = adamw.init(params)._replace(step=torch.tensor(
            OPT_STEP0, dtype=torch.int32))
        with routes(force):
            _, opt, m2 = steps.make_train_step(model, run, mesh)(params, opt,
                                                                 batch)
        for k, v in m2.items():
            out[f"{arch}/step/{k}"] = v.detach().numpy()
        for tag, tree in (("p2", params), ("m2", opt.m), ("v2", opt.v)):
            for k, v in gather_params(tree, sh).items():
                out[f"{arch}/{tag}/{k}"] = v.detach().numpy()
        # AdamW alone on the blocks of the input gradients.
        jg = {}
        for k in sh:
            key, i = _repro_key(k)
            jg[k] = torch.from_numpy(_layer(ref[f"in/{arch}/grads/{key}"],
                                            i))
        p0 = shard_params({k: p.detach().clone()
                           for k, p in full.named_parameters()}, sh)
        o0 = adamw.init(p0)._replace(step=torch.tensor(OPT_STEP0,
                                                       dtype=torch.int32))
        lr = adamw.schedule(run, o0.step)
        p1, _, gn = adamw.update(shard_params(jg, sh), o0, p0, run, lr, sh)
        out[f"{arch}/upd/grad_norm"] = gn.numpy()
        for k, v in gather_params(p1, sh).items():
            out[f"{arch}/upd/{k}"] = v.numpy()
        if arch == TRAIN_ARCHS[0]:
            mgr = CheckpointManager(ckpt_dir, async_save=True)
            state = {"params": params, "opt": opt}
            mgr.save(1, state, shardings={
                "params": sh, "opt": adamw.state_shardings(sh)})
            mgr.wait()


def _dryrun_rank(mesh, ref, out):
    """The dry-run's cells of DRYRUN_GLOO_ARCHS stepped on this rank with
    ``repro``'s weights, unforced: the collectives the step calls by kind
    (``launch.dryrun.counted_collectives``: "dryrun/{arch}/{kind}/rank{r}
    /bytes/{kind}" and ".../calls/{kind}"), FlopCounterMode's total and
    the bytes of the step's inputs on this rank (its blocks, AdamW's
    state, its batch rows, its cache)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (model_shardings, shard_params,
                                            split_batch)
    run = RunConfig(**RUN_KNOBS)

    def size(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)
    for arch in DRYRUN_GLOO_ARCHS:
        model = build_model(configs.get_reduced_config(arch), "meta",
                            trainable=True)
        full = port_model(arch, ref)
        toks = torch.from_numpy(ref[f"in/{arch}/tokens"])
        for kind in DRYRUN_KINDS:
            params = shard_params({k: p.detach() for k, p in
                                   full.named_parameters()},
                                  model_shardings(model, mesh))
            held = list(params.values())
            if kind == "train":
                for p in held:
                    p.requires_grad_(True)
                opt = adamw.init(params)
                batch = {"tokens": toks, "labels": torch.from_numpy(
                    ref[f"in/{arch}/labels"])}
                held += [*opt.m.values(), *opt.v.values(), opt.step]
                step = steps.make_train_step(model, run, mesh)
                args = (params, opt, batch)
            elif kind == "prefill":
                batch = {"tokens": toks}
                step = steps.make_prefill_step(model, run, mesh)
                args = (params, batch)
            else:
                batch = {"tokens": toks[:, :1].contiguous()}
                cache = steps.local_cache(model, mesh, TRAIN_B, TRAIN_S,
                                          "cpu")
                held += [t for _, t in steps._leaves(cache)]
                step = steps.make_serve_step(model, run, mesh)
                args = (params, batch["tokens"], cache)
            held += list(split_batch(mesh, batch)[1].values())
            with dryrun.counted_collectives() as tally, \
                    FlopCounterMode(display=False) as flops:
                step(*args)
            pre = f"dryrun/{arch}/{kind}/rank{mesh.rank}/"
            out[pre + "flops"] = np.int64(flops.get_total_flops())
            out[pre + "argument_size"] = np.int64(size(held))
            for c in COLLECTIVE_KINDS:
                out[pre + f"bytes/{c}"] = np.int64(tally.bytes[c])
                out[pre + f"calls/{c}"] = np.int64(tally.counts[c])


def _repro_routes(out_dir, arch, cfg, mesh):
    """``repro``'s routing of this rank's data shard in each MoE layer of
    the train step (``jax_routes``: the JAX child writes ROUTES_FILE to
    ``out_dir``; waited for up to RANK_TIMEOUT_S), to force on the port's
    router (``routes``); None for a dense arch."""
    import time

    import torch
    if not cfg.n_experts:
        return None
    path = os.path.join(out_dir, ROUTES_FILE)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} from the JAX child")
        time.sleep(0.2)
    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    n = TRAIN_B * TRAIN_S // mesh.shape["data"]
    lo = mesh.coords["data"] * n
    return [torch.from_numpy(got[f"{arch}/routes/ids{i}"][lo:lo + n])
            for i in range(cfg.n_layers - cfg.first_dense_layers)]


def _steps_rank(mesh, ref, out, tmp):
    """The port's side of ``jax_reference_steps`` on this rank."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import driver, steps
    from repro_torch.sharding.rules import (gather_params, gather_rows,
                                            model_shardings, shard_params,
                                            split_batch)
    run = RunConfig(**RUN_KNOBS)

    def blocks(arch, model, m):
        full = port_model(arch, ref)
        return shard_params({k: p.detach() for k, p in
                             full.named_parameters()},
                            model_shardings(model, m))
    for arch in TRAIN_ARCHS:
        model = build_model(configs.get_reduced_config(arch), "meta",
                            trainable=True)
        params = blocks(arch, model, mesh)
        toks = torch.from_numpy(ref[f"in/{arch}/tokens"])
        # One process's forward and decode of each data shard's rows
        # (the MoE's capacity is per data shard), their routing recorded.
        full = port_model(arch, ref)
        half = TRAIN_B // mesh.shape["data"]
        one_last, one_dec, one_routes = [], [], []
        for d in range(mesh.shape["data"]):
            rows = toks[d * half:(d + 1) * half]
            with torch.inference_mode(), routes() as rc:
                logits, _ = full.forward(run, {"tokens": rows})
                one_last.append(logits[:, -1])
                cache = full.init_cache(half, DECODE_LEN)
                for t in range(DECODE_STEPS):
                    lg, cache = full.decode_step(run, rows[:, t:t + 1],
                                                 cache)
                    one_dec.append((d, t, lg[:, -1]))
            one_routes.append(rc)
        out[f"{arch}/prefill_one"] = torch.cat(one_last).float().numpy()
        for t in range(DECODE_STEPS):
            out[f"{arch}/decode_one{t}"] = torch.cat(
                [lg for d, tt, lg in one_dec if tt == t]).float().numpy()
        force = one_routes[mesh.coords["data"]]
        n_fwd = len(force) // (1 + DECODE_STEPS)
        with routes(force[:n_fwd]), partials() as rec:
            out[f"{arch}/prefill"] = steps.make_prefill_step(
                model, run, mesh)(params, {"tokens": toks}).numpy()
        _partials_vs_one(mesh, full, rec, out, arch)
        tree = steps.compute_params(model, params, mesh)
        serve = steps.make_serve_step(model, run, mesh)
        cache = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        cache2 = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        out[f"{arch}/cache_k/rank{mesh.rank}"] = np.array(cache["k"].shape)
        for t in range(DECODE_STEPS):
            view, rows = split_batch(mesh, {"tokens": toks[:, t:t + 1]})
            step_routes = force[n_fwd * (1 + t):n_fwd * (2 + t)]
            with torch.inference_mode(), steps.bound(model, tree), \
                    routes(step_routes):
                logits, cache = model.decode_step(run, rows["tokens"], cache,
                                                  mesh=view)
            out[f"{arch}/decode{t}"] = gather_rows(view, steps._last_row(
                model, view, logits).float()).numpy()
            with routes(step_routes):
                nxt, cache2 = serve(tree, toks[:, t:t + 1], cache2)
            out[f"{arch}/serve{t}"] = nxt.numpy()
    arch = TRAIN_ARCHS[1]
    batch = {"tokens": torch.from_numpy(ref[f"in/{arch}/tokens"]),
             "labels": torch.from_numpy(ref[f"in/{arch}/labels"])}
    dmesh = make_mesh(DATA_MESH, ("data",))
    one = make_mesh((1,), ("data",))
    # The data mesh against one process's (1,) mesh, routed as it routed.
    model = build_model(configs.get_reduced_config(arch), "meta",
                        trainable=True)
    grads = {}
    force = None
    for tag, m in (("data_one", one), ("data_mesh", dmesh)):
        params = blocks(arch, model, m)
        for p in params.values():
            p.requires_grad_(True)
        with routes(force) as rc:
            g, metrics = steps.make_grad_fn(model, run, m)(params, batch)
        force = rc
        grads[tag] = gather_params(g, model_shardings(model, m))
        for k, v in metrics.items():
            out[f"{tag}/metrics/{k}"] = v.numpy()
    for k, g in grads["data_mesh"].items():
        out[f"data_mesh/g/{k}"] = g.numpy()
        out[f"data_one/g/{k}"] = grads["data_one"][k].numpy()
    # qwen's prefill on the data mesh ("model" of extent 1) against one
    # process's forward of each row.
    qarch = TRAIN_ARCHS[0]
    qmodel = build_model(configs.get_reduced_config(qarch), "meta",
                         trainable=True)
    qtoks = torch.from_numpy(ref[f"in/{qarch}/tokens"])
    got = steps.make_prefill_step(qmodel, run, dmesh)(
        blocks(qarch, qmodel, dmesh), {"tokens": qtoks})
    qfull = port_model(qarch, ref)
    with torch.inference_mode():
        want = torch.cat([qfull.forward(run, {"tokens": qtoks[i:i + 1]})[0][
            :, -1] for i in range(TRAIN_B)])
    out["data_mesh/prefill"] = got.numpy()
    out["data_mesh/prefill_one"] = want.numpy()
    _data_moe_rank(dmesh, ref, out)
    for tag, m, r in (("data_mesh", dmesh, run),
                      ("microbatch", mesh, RunConfig(**RUN_KNOBS,
                                                     microbatch=2))):
        params = blocks(arch, model, m)
        for p in params.values():
            p.requires_grad_(True)
        opt = adamw.init(params)._replace(step=torch.tensor(
            OPT_STEP0, dtype=torch.int32))
        _, _, m2 = steps.make_train_step(model, r, m)(params, opt, batch)
        for k, v in m2.items():
            out[f"{tag}/step/{k}"] = v.detach().numpy()
    # train_loop with a failure, and a clean run of the same steps.
    arch = TRAIN_ARCHS[0]
    src = ArraySource(ref[f"in/{arch}/loop_tokens"],
                      ref[f"in/{arch}/loop_labels"], torch.from_numpy)
    for tag, fail in (("loop", {LOOP_FAIL}), ("loop_clean", set())):
        model = build_model(configs.get_reduced_config(arch), "meta",
                            trainable=True)
        sh = model_shardings(model, mesh)
        params = blocks(arch, model, mesh)
        for p in params.values():
            p.requires_grad_(True)
        dcfg = driver.DriverConfig(total_steps=LOOP_STEPS,
                                   ckpt_every=LOOP_EVERY,
                                   ckpt_dir=os.path.join(tmp, tag))
        params, opt, hist = driver.train_loop(
            steps.make_train_step(model, run, mesh), params,
            adamw.init(params), src, dcfg,
            {"params": sh, "opt": adamw.state_shardings(sh)},
            fail_at=fail, log=lambda *_: None)
        out[f"{tag}/loss"] = np.asarray(hist["loss"], np.float32)
        out[f"{tag}/restarts"] = np.asarray(hist["restarts"])
        for k, v in gather_params(params, sh).items():
            out[f"{tag}/p/{k}"] = v.detach().numpy()


def _data_moe_rank(mesh, ref, out):
    """DATA_MOE_ARCHS on the data mesh ``mesh`` and in one process over the
    whole batch ("data_moe/{arch}/{one,mesh}/..." keys): the prefill step
    and decode steps' last-position logits ("logits{j}", the prefill
    first), and every MoE call's routed ids, dropped pairs and
    load-balance loss."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import build_model
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (gather_rows, model_shardings,
                                            shard_params, split_batch)
    run = RunConfig(**RUN_KNOBS)
    for arch, decode in DATA_MOE_ARCHS.items():
        full = port_model(arch, ref)
        model = build_model(configs.get_reduced_config(arch), "meta",
                            trainable=True)
        params = shard_params({k: p.detach() for k, p in
                               full.named_parameters()},
                              model_shardings(model, mesh))
        toks = torch.from_numpy(ref[f"in/{arch}/tokens"])
        n_dec = DECODE_STEPS if decode else 0
        with torch.inference_mode(), routes() as ids, moe_aux() as aux:
            logits = [full.forward(run, {"tokens": toks})[0][:, -1]]
            cache = full.init_cache(TRAIN_B, DECODE_LEN)
            # A decode step's f32 head one row at a time, as each rank
            # computes it: a one-row product rounds unlike an 8-row one.
            head = full._logits
            full._logits = lambda x, *a: torch.cat(
                [head(x[i:i + 1], *a) for i in range(x.shape[0])])
            for t in range(n_dec):
                lg, cache = full.decode_step(run, toks[:, t:t + 1], cache)
                logits.append(lg[:, -1])
            del full._logits
        one = (logits, ids, aux)
        tree = steps.compute_params(model, params, mesh)
        cache = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        with routes() as ids, moe_aux() as aux:
            logits = [steps.make_prefill_step(model, run, mesh)(
                params, {"tokens": toks})]
            for t in range(n_dec):
                view, rows = split_batch(mesh, {"tokens": toks[:, t:t + 1]})
                with torch.inference_mode(), steps.bound(model, tree):
                    lg, cache = model.decode_step(run, rows["tokens"], cache,
                                                  mesh=view)
                logits.append(gather_rows(view, steps._last_row(
                    model, view, lg)))
        for tag, (logits, ids, aux) in (("one", one),
                                        ("mesh", (logits, ids, aux))):
            pre = f"data_moe/{arch}/{tag}"
            for j, lg in enumerate(logits):
                out[f"{pre}/logits{j}"] = lg.float().numpy()
            out[f"{pre}/ids"] = torch.cat(ids).numpy()
            for j, y in enumerate(aux.pop("y")):
                y = y if tag == "one" else mesh.all_gather(y, "data", 0)
                out[f"{pre}/y{j}"] = y.float().numpy()
            for k, v in aux.items():
                out[f"{pre}/{k}"] = torch.stack(v).numpy()


def _xattn_rank(mesh, ref, out):
    """The port's side of ``jax_reference_steps``' cross-attention cases
    on this rank: the (2, 4) prefill, decode and serve steps (each rank's
    cache leaf shapes, "/rank" keys), one train step's metrics and
    gradients (gathered); the (8,) data mesh's prefill beside one
    process's forward of each row."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (gather_params, gather_rows,
                                            model_shardings, shard_params,
                                            split_batch)
    run = RunConfig(**XATTN_KNOBS)
    dmesh = make_mesh(DATA_MESH, ("data",))
    for arch in XATTN_ARCHS:
        cfg = configs.get_reduced_config(arch)
        model = build_model(cfg, "meta", trainable=True)
        sh = model_shardings(model, mesh)
        full = port_model(arch, ref)
        whole = {k: p.detach() for k, p in full.named_parameters()}
        params = shard_params(whole, sh)
        batch = xattn_batch(ref, arch, torch.from_numpy)
        fwd = {k: v for k, v in batch.items() if k != "labels"}
        toks = batch["tokens"]
        out[f"{arch}/prefill"] = steps.make_prefill_step(model, run, mesh)(
            params, fwd).numpy()
        tree = steps.compute_params(model, params, mesh)
        serve = steps.make_serve_step(model, run, mesh)
        cache = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        cache2 = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        for k, c in cache.items():
            if k != "pos":
                out[f"{arch}/cache_{k}/rank{mesh.rank}"] = np.array(c.shape)
        for t in range(DECODE_STEPS):
            view, rows = split_batch(mesh, {"tokens": toks[:, t:t + 1]})
            with torch.inference_mode(), steps.bound(model, tree):
                logits, cache = model.decode_step(run, rows["tokens"], cache,
                                                  mesh=view)
            out[f"{arch}/decode{t}"] = gather_rows(view, steps._last_row(
                model, view, logits).float()).numpy()
            nxt, cache2 = serve(tree, toks[:, t:t + 1], cache2)
            out[f"{arch}/serve{t}"] = nxt.numpy()
        for p in params.values():
            p.requires_grad_(True)
        grads, metrics = steps.make_grad_fn(model, run, mesh)(params, batch)
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}"] = v.numpy()
        for k, g in gather_params(grads, sh).items():
            out[f"{arch}/g/{k}"] = g.float().numpy()
        opt = adamw.init(params)._replace(step=torch.tensor(
            OPT_STEP0, dtype=torch.int32))
        _, _, m2 = steps.make_train_step(model, run, mesh)(params, opt,
                                                           batch)
        for k, v in m2.items():
            out[f"{arch}/step/{k}"] = v.detach().numpy()
        # The data mesh ("model" of extent 1): one process's rows.
        got = steps.make_prefill_step(model, run, dmesh)(
            shard_params(whole, model_shardings(model, dmesh)), fwd)
        with torch.inference_mode():
            want = torch.cat([full.forward(run, {k: v[i:i + 1] for k, v in
                                                 fwd.items()})[0][:, -1]
                              for i in range(TRAIN_B)])
        out[f"{arch}/data_mesh/prefill"] = got.numpy()
        out[f"{arch}/data_mesh/prefill_one"] = want.numpy()


def _last_routes(out_dir, arch, cfg, mesh, tag):
    """``repro``'s routing of this rank's data shard in each MoE layer of
    the call ``tag`` ("train", "prefill", "decode{t}") from
    LAST_ROUTES_FILE (waited for up to RANK_TIMEOUT_S); None for an arch
    without experts."""
    import time

    import torch
    if not cfg.n_experts:
        return None
    path = os.path.join(out_dir, LAST_ROUTES_FILE)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} from the JAX child")
        time.sleep(0.2)
    with np.load(path) as z:
        got = [z[f"{arch}/{tag}/ids{i}"]
               for i in range(cfg.n_layers - cfg.first_dense_layers)]
    n = got[0].shape[0] // mesh.shape["data"]
    lo = mesh.coords["data"] * n
    return [torch.from_numpy(ids[lo:lo + n]) for ids in got]


def _last_rank(mesh, ref, out, out_dir):
    """The LAST_ARCHS cases on this rank (``jax_reference_last``'s, the
    port's side): the prefill, decode and serve steps (DeepSeek-V2 routed
    as ``repro`` routed each call; each rank's cache leaf shapes, "/rank"
    keys), one train step's metrics (for LAST_GRADS its two halves,
    ``make_grad_fn`` and ``adamw.update``, with the gradients gathered
    and the port's own routing before the forcing); then LAST_BLOCKS
    (``_block_rank``)."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (gather_params, gather_rows,
                                            model_shardings, shard_params,
                                            split_batch)
    for arch in LAST_ARCHS:
        cfg = configs.get_reduced_config(arch)
        run = last_run(arch, RunConfig)
        model = build_model(cfg, "meta", trainable=True)
        sh = model_shardings(model, mesh)
        full = port_model(arch, ref)
        whole = {k: p.detach() for k, p in full.named_parameters()}
        params = shard_params(whole, sh)
        batch = {k: torch.from_numpy(ref[f"in/{arch}/{k}"])
                 for k in ("tokens", "labels")}
        toks = batch["tokens"]

        def force(tag):
            return _last_routes(out_dir, arch, cfg, mesh, tag)
        with routes(force("prefill")):
            out[f"{arch}/prefill"] = steps.make_prefill_step(
                model, run, mesh)(params, {"tokens": toks}).numpy()
        tree = steps.compute_params(model, params, mesh)
        serve = steps.make_serve_step(model, run, mesh)
        cache = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        cache2 = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        for path, c in _cache_leaves(cache):
            out[f"{arch}/cache_{path}/rank{mesh.rank}"] = np.array(c.shape)
        for t in range(DECODE_STEPS):
            view, rows = split_batch(mesh, {"tokens": toks[:, t:t + 1]})
            with torch.inference_mode(), steps.bound(model, tree), \
                    routes(force(f"decode{t}")):
                logits, cache = model.decode_step(run, rows["tokens"], cache,
                                                  mesh=view)
            out[f"{arch}/decode{t}"] = gather_rows(view, steps._last_row(
                model, view, logits).float()).numpy()
            with routes(force(f"decode{t}")):
                nxt, cache2 = serve(tree, toks[:, t:t + 1], cache2)
            out[f"{arch}/serve{t}"] = nxt.numpy()
        for p in params.values():
            p.requires_grad_(True)
        opt = adamw.init(params)._replace(step=torch.tensor(
            OPT_STEP0, dtype=torch.int32))
        if arch in LAST_GRADS:
            # make_train_step's two halves, the gradients kept between.
            with routes(force("train")) as own:
                grad_fn = steps.make_grad_fn(model, run, mesh)
                grads, m2 = grad_fn(params, batch)
            for i, ids in enumerate(
                    own[:cfg.n_layers - cfg.first_dense_layers]):
                out[f"{arch}/own_ids{i}/rank{mesh.rank}"] = ids.numpy()
            for k, g in gather_params(grads, sh).items():
                out[f"{arch}/g/{k}"] = g.float().numpy()
            lr = adamw.schedule(run, opt.step)
            _, _, gnorm = adamw.update(grads, opt, params, run, lr,
                                       grad_fn.shardings)
            m2 = dict(m2, grad_norm=gnorm, lr=lr)
        else:
            with routes(force("train")):
                _, _, m2 = steps.make_train_step(model, run, mesh)(
                    params, opt, batch)
        for k, v in m2.items():
            out[f"{arch}/step/{k}"] = v.detach().numpy()
        for a, prefixes, kind in LAST_BLOCKS:
            if a == arch:
                _block_rank(mesh, cfg, whole, sh, prefixes, kind, out)


def _subtree(tree, prefix):
    for k in prefix.split("."):
        tree = tree[k]
    return tree


def _block_fn(kind, cfg, run):
    """``fn(tree, x, mesh) -> y`` of a LAST_BLOCKS kind (``tree``: the
    nested parameters, full names) and, for the recurrent kinds, ``step(
    tree, x, state, mesh) -> (y, state)``."""
    import torch
    from repro_torch.models import attention, ffn, ssm, xlstm
    from repro_torch.models import transformer as tf

    def pos(x):
        return torch.arange(x.shape[1], dtype=torch.int32)
    if kind == "mla":
        return (lambda t, x, m: attention.mla_self_attn(
            _subtree(t, "blocks.0.attn"), cfg, x, positions=pos(x),
            chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv,
            mesh=m)), None
    if kind == "shared_ffn":
        return (lambda t, x, m: ffn.ffn(
            _subtree(t, "blocks.0.moe.shared"), x, "swiglu", m,
            cfg.d_ff_expert * cfg.n_shared_experts)), None
    if kind == "shared_attn":
        def fn(t, x, m):
            return tf._shared_attn(t["shared"], _subtree(t, "groups.1.lora"),
                                   cfg, run, x, pos(x), m)

        def step(t, x, st, m):
            y, k, v = tf._shared_attn_decode(
                t["shared"], _subtree(t, "groups.1.lora"), cfg, x,
                st["k"], st["v"], torch.tensor(3, dtype=torch.int32), m)
            return y, {"k": k, "v": v}
        return fn, step
    mod, name, prefix = {"mamba2": (ssm, "mamba2", "groups.0.mambas.0"),
                         "mlstm": (xlstm, "mlstm", "groups.0.mlstms.0"),
                         "slstm": (xlstm, "slstm", "groups.1.slstm")}[kind]
    kw = {} if kind == "slstm" else {"chunk": LAST_CHUNK}
    return (lambda t, x, m: getattr(mod, name)(
        _subtree(t, prefix), cfg, x, mesh=m, **kw)), \
        (lambda t, x, st, m: getattr(mod, name + "_step")(
            _subtree(t, prefix), cfg, x, st, mesh=m))


def _block_state(kind, cfg, b, rng):
    """A random whole decode state of a recurrent LAST_BLOCKS kind (b rows;
    the stabilizers finite) and, per leaf, (the heads axis, the channels
    the conv splits: (di, n) or None)."""
    import torch
    from repro_torch.models import ssm, xlstm
    if kind == "mamba2":
        st = ssm.mamba2_init_state(cfg, b, cfg.d_model)
        di = cfg.ssm_expand * cfg.d_model
        axes = {"S": (1, None), "conv": (None, (di, cfg.ssm_state))}
    elif kind == "shared_attn":
        shape = (b, DECODE_LEN, cfg.n_kv_heads, cfg.hd)
        st = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
        axes = {"k": (2, None), "v": (2, None)}
    else:
        st = (xlstm.mlstm_init_state if kind == "mlstm"
              else xlstm.slstm_init_state)(cfg, b)
        axes = {k: (1, None) for k in st}
    return {k: torch.from_numpy(rng.normal(size=v.shape).astype(
        np.float32)) for k, v in st.items()}, axes


def _state_block(t, axis, conv, mesh, m):
    """This rank's block of a whole state leaf: its heads (axis), or its
    x channels and the B / C ones (conv)."""
    import torch
    i = mesh.index("model")
    if conv is None:
        n = t.shape[axis] // m
        return t.narrow(axis, i * n, n)
    di, ns = conv
    dl = di // m
    return torch.cat([t[..., i * dl:(i + 1) * dl], t[..., di:di + 2 * ns]],
                     -1)


def _block_rank(mesh, cfg, whole, sh, prefixes, kind, out):
    """One LAST_BLOCKS case on this rank, in f32 (its leaves as placed
    blocks through ``_compute_tree``, the train step's tree: re-blocked
    pieces, whole leaves read in part), against one process's block on
    the whole batch: the output's rows (max error over the max of one
    process's), each leaf's gradient block normwise beside its norm and
    the largest leaf gradient norm of the block; for the recurrent kinds
    one decode step from a random state (output rows, each state leaf's
    block)."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (local_shard, split_batch,
                                            tp_leaves, tp_pieces)
    from repro_torch.models.model import build_model
    run = last_run(cfg.name.removesuffix("-reduced"), RunConfig)
    fn, step = _block_fn(kind, cfg, run)
    model = build_model(cfg, "meta", trainable=True)
    keep, pieces = tp_leaves(model, mesh), tp_pieces(model, mesh)
    names = [k for k in whole if any(k.startswith(p + ".") for p in prefixes)]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(TRAIN_B, TRAIN_S, cfg.d_model))
                         .astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    view, rows = split_batch(mesh, {"x": x, "cot": cot})
    blocks = {k: local_shard(whole[k], sh[k].spec, mesh).clone()
              .requires_grad_(True) for k in names}
    tree = steps._compute_tree(blocks, {k: sh[k] for k in names},
                               view.batch_axes, keep, pieces)
    y = fn(_nest_names(tree), rows["x"], view)
    g = torch.autograd.grad(torch.sum(y.float() * rows["cot"]),
                            list(blocks.values()))
    one = {k: whole[k].clone().requires_grad_(True) for k in names}
    y1 = fn(_nest_names(one), x, None)
    g1 = torch.autograd.grad(torch.sum(y1.float() * cot), list(one.values()))
    lo = mesh.coords["data"] * rows["x"].shape[0]
    half = slice(lo, lo + rows["x"].shape[0])
    tag, r = f"block/{cfg.name}/{kind}", mesh.rank
    out[f"{tag}/y/rank{r}"] = np.float64(
        (y.detach() - y1.detach()[half]).abs().max()
        / y1.detach().abs().max())
    top = max(float(w.norm()) for w in g1)
    for k, got, want in zip(names, g, g1):
        want = local_shard(want, sh[k].spec, mesh)
        out[f"{tag}/g/{k}/rank{r}"] = np.array([
            float((got - want).norm() / want.norm()),
            float((got - want).norm()), float(want.norm()), top])
    if step is None:
        return
    st, axes = _block_state(kind, cfg, TRAIN_B, rng)
    m = mesh.shape["model"]
    xs = x[:, :1]
    with torch.inference_mode():
        tree = steps._compute_tree(blocks, {k: sh[k] for k in names}, (),
                                   keep, pieces)
        mine = {k: _state_block(v[half], *axes[k], mesh, m).clone()
                for k, v in st.items()}
        y, new = step(_nest_names(tree), xs[half], mine, view)
        y1, new1 = step(_nest_names({k: v.detach() for k, v in
                                     one.items()}), xs,
                        {k: v.clone() for k, v in st.items()}, None)
    out[f"{tag}/step_y/rank{r}"] = np.float64(
        (y - y1[half]).abs().max() / y1.abs().max())
    for k, v in new.items():
        want = _state_block(new1[k][half], *axes[k], mesh, m)
        out[f"{tag}/step_{k}/rank{r}"] = np.float64(
            (v - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _sp_fn(arch, kind, cfg, run, img):
    """``fn(tree, x, mesh, s) -> y`` of an SP_BLOCKS block (``tree``: the
    nested parameters, full names; ``s`` the whole sequence's length;
    ``img`` the vlm's image rows, as x's)."""
    import torch
    from repro_torch.models import attention, layers
    from repro_torch.models import transformer as tf
    pre = dict((c[0], c[2][0]) for c in SP_BLOCKS if c[1] == kind
               and c[0] == arch)[arch]

    def pos(s):
        return torch.arange(s, dtype=torch.int32)

    def fn(t, x, m, s):
        p = _subtree(t, pre)
        if kind == "dense":
            return tf.dense_block(p, cfg, run, x, pos(s), m)
        if kind == "encoder":
            return tf.dense_block_bidir(p, cfg, run, x, pos(s), m)
        if kind == "moe":
            return tf.moe_block(p, cfg, run, x, pos(s), m)[0]
        if kind == "mla":
            return attention.mla_self_attn(
                p, cfg, x, positions=pos(s), chunk_q=run.attn_chunk_q,
                chunk_kv=run.attn_chunk_kv, mesh=m,
                sp=layers.seq_parallel(m, s))
        if kind == "cross":
            kv = tf.cross_img_kv(p, cfg, img.to(x.dtype), m)
            return tf.cross_block(p, cfg, run, x, kv, m,
                                  layers.seq_parallel(m, s))
        return tf._shared_attn(p, _subtree(t, "groups.0.lora"), cfg, run, x,
                               pos(s), m)
    return fn


def _sp_rank(mesh, ref, out):
    """The sequence-parallel residual on this rank: ``scatter_fwd`` /
    ``block_fwd`` against ``psum`` / ``all_gather`` (forward and
    backward, bit for bit), then each SP_BLOCKS block (see SP_BLOCKS):
    the output's shape (zamba2's shared block: the residual's inside it),
    its distance from the same block with the residual whole and from
    one process on the rank's rows (the serving tree, bf16), at TRAIN_S
    and at SP_ODD_S; for SP_GRADS each leaf's gradient block in f32
    against one process on the whole batch.  The MoE blocks route as the
    whole-residual run routed."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import block_fwd, scatter_fwd
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model
    from repro_torch.models.module import init_params_into
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (local_shard, model_shardings,
                                            split_batch, tp_leaves,
                                            tp_pieces)
    r, i = mesh.rank, mesh.index("model")
    # Integers: every order of the sum gives the same bits.
    x = torch.arange(96.0).reshape(2, 16, 3) * (r + 1)
    cot = torch.arange(24.0).reshape(2, 4, 3) - 3 * r
    mine = slice(4 * i, 4 * i + 4)
    for tag, op, want in (("scatter", scatter_fwd,
                           mesh.psum(x, "model")[:, mine]),
                          ("block", block_fwd, x[:, mine])):
        xg = x.clone().requires_grad_(True)
        y = op(xg, mesh, "model", 1)
        g, = torch.autograd.grad(y, xg, cot)
        out[f"sp/{tag}/rank{r}"] = np.array([
            torch.equal(y, want), y.is_contiguous(),
            torch.equal(g, mesh.all_gather(cot, "model", 1))])
    run = RunConfig(**RUN_KNOBS)
    m = mesh.shape["model"]
    models = {}
    for arch, kind, prefixes in SP_BLOCKS:
        cfg = configs.get_reduced_config(arch)
        if arch not in models:
            if f"w/{arch}/embed/table" in ref:
                full = port_model(arch, ref)
            else:
                full = build_model(cfg, "cpu", trainable=True)
                init_params_into(full, torch.Generator().manual_seed(SP_SEED))
            models[arch] = full
        whole = {k: p.detach() for k, p in models[arch].named_parameters()}
        model = build_model(cfg, "meta", trainable=True)
        sh = model_shardings(model, mesh)
        keep, pieces = tp_leaves(model, mesh), tp_pieces(model, mesh)
        names = [k for k in whole
                 if any(k.startswith(p + ".") for p in prefixes)]
        blocks = {k: local_shard(whole[k], sh[k].spec, mesh) for k in names}
        rng = np.random.default_rng(8)
        tag = f"sp/{arch}/{kind}"
        for s in (TRAIN_S, SP_ODD_S):
            xs = torch.from_numpy(rng.normal(size=(
                TRAIN_B, s, cfg.d_model)).astype(np.float32))
            img = torch.from_numpy(rng.normal(size=(
                TRAIN_B, cfg.n_img_tokens or 1, cfg.d_vision or 1)).astype(
                    np.float32))
            view, rows = split_batch(mesh, {"x": xs, "img": img})
            fn = _sp_fn(arch, kind, cfg, run, rows["img"])
            n = s // m if s % m == 0 else s
            blk = rows["x"][:, i * n:(i + 1) * n] if n != s else rows["x"]
            inner = []
            real_out = tf._shared_out

            def shared_out(shared, attn, cfg_, xx, *a, **k):
                inner.append(tuple(xx.shape))
                return real_out(shared, attn, cfg_, xx, *a, **k)
            tree = _nest_names(steps._compute_tree(
                blocks, {k: sh[k] for k in names}, (), keep, pieces))
            one = _nest_names(whole)
            with torch.inference_mode():
                with routes() as rc, whole_residual():
                    y_whole = fn(tree, rows["x"], view, s)
                tf._shared_out = shared_out
                try:
                    with routes(rc or None):
                        y = fn(tree, rows["x"] if kind == "shared" else blk,
                               view, s)
                finally:
                    tf._shared_out = real_out
                with routes(rc or None):
                    y_one = fn(one, rows["x"], None, s)
            if kind != "shared":
                y_whole, y_one = (t[:, i * n:(i + 1) * n] if n != s else t
                                  for t in (y_whole, y_one))
            out[f"{tag}/{s}/shape/rank{r}"] = np.array(
                inner[0] if kind == "shared" else y.shape)
            out[f"{tag}/{s}/vs_whole/rank{r}"] = np.array([
                float((y.float() - y_whole.float()).abs().max()),
                torch.equal(y, y_whole)])
            out[f"{tag}/{s}/vs_one/rank{r}"] = np.float64(
                (y.float() - y_one.float()).abs().max())
            if (arch, kind, prefixes) not in SP_GRADS or s != TRAIN_S:
                continue
            cot = torch.from_numpy(rng.normal(size=xs.shape).astype(
                np.float32))
            _, crow = split_batch(mesh, {"c": cot})
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in blocks.items()}
            with f32_blocks():
                tree = _nest_names(steps._compute_tree(
                    leaves, {k: sh[k] for k in names}, view.batch_axes, keep,
                    pieces))
                xin = rows["x"] if kind == "shared" else blk
                cin = crow["c"] if kind == "shared" else \
                    crow["c"][:, i * n:(i + 1) * n]
                y = fn(tree, xin, view, s)
                g = torch.autograd.grad(torch.sum(y.float() * cin),
                                        list(leaves.values()))
                lone = {k: whole[k].clone().requires_grad_(True)
                        for k in names}
                fn1 = _sp_fn(arch, kind, cfg, run, img)
                y1 = fn1(_nest_names(lone), xs, None, s)
                g1 = torch.autograd.grad(torch.sum(y1.float() * cot),
                                         list(lone.values()))
            top = max(float(w.norm()) for w in g1)
            for k, got, want in zip(names, g, g1):
                want = local_shard(want, sh[k].spec, mesh)
                out[f"{tag}/g/{k}/rank{r}"] = np.array([
                    float((got - want).norm() / want.norm()),
                    float((got - want).norm()), float(want.norm()), top])


def _nest_names(flat_tree: dict) -> dict:
    """A nested dict of {"a.b.c": leaf} (the port's parameter names)."""
    return nest({k.replace(".", "/"): v for k, v in flat_tree.items()})


def _cache_leaves(cache, pre=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{pre}{k}/")
        elif k != "pos":
            yield pre + k, v


def _partials_vs_one(mesh, full, rec, out, arch):
    """Layer 0's row-parallel products on this rank against one process's
    product of the same slices: its input columns by the rows of the
    whole weight (``full``'s) that its block holds, in the input's dtype;
    True where bit-equal (``/rank`` keys: every rank's is kept)."""
    import torch
    whole = {"wo": "blocks.0.attn.wo.w", "w_down": "blocks.0.ffn.w_down.w"}
    params = dict(full.named_parameters())
    for tag, name in whole.items():
        if name not in params:
            continue
        calls = [c for c in rec if c[0] == tag]
        _, x, w, partial = calls[0]
        n = w.shape[0]
        lo = mesh.index("model") * n
        rows = params[name].detach()[lo:lo + n]
        want = x @ rows.to(x.dtype)
        out[f"{arch}/partial_{tag}/rank{mesh.rank}"] = np.array([
            torch.equal(w.float(), rows.float()),
            torch.equal(partial.float(), want.float()),
            n * mesh.shape["model"] ==
            params[name].shape[0]])


def _tp_rank(mesh, out):
    """The tensor-parallel pieces on this rank: each TREE_CASES arch's
    compute trees (serving and training), each leaf's share of its whole
    elements ("tree/...": rank 0's); the vocab-parallel ``cross_entropy``
    and its gradient against the whole vocab's on this rank's rows, and
    the vocab-split embedding against one process's gather-then-cast
    ("/rank" keys)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (init_sharded, model_shardings,
                                            split_batch, tp_leaves,
                                            tp_pieces)
    for arch, changes in TREE_CASES.items():
        cfg = dataclasses.replace(configs.get_reduced_config(arch),
                                  **changes)
        model = build_model(cfg, "meta", trainable=True)
        sh = model_shardings(model, mesh)
        whole = dict(model.named_parameters())
        params = init_sharded(model, sh, torch.Generator().manual_seed(4),
                              "cpu")
        trees = {"serve": steps.compute_params(model, params, mesh),
                 "train": steps._compute_tree(
                     steps.cast_params(params), sh, ("data",),
                     tp_leaves(model, mesh), tp_pieces(model, mesh))}
        for tag, tree in trees.items():
            for name, t in tree.items():
                if mesh.rank == 0:
                    out[f"tree/{arch}/{tag}/{name}"] = np.float64(
                        t.numel() / whole[name].numel())
    b, s, v = VOCAB_CE
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(b, s, v)).astype(np.float32)
                              * 4)
    labels = torch.from_numpy(rng.integers(0, v, (b, s)).astype(np.int32))
    view, rows = split_batch(mesh, {"logits": logits, "labels": labels})
    n = v // mesh.shape["model"]
    lo = mesh.index("model") * n
    blk = rows["logits"][..., lo:lo + n].clone().requires_grad_(True)
    loss, ce = steps.cross_entropy(blk, rows["labels"], 1e-4, view, v)
    g, = torch.autograd.grad(loss, blk)
    whole_l = rows["logits"].clone().requires_grad_(True)
    loss1, ce1 = steps.cross_entropy(whole_l, rows["labels"], 1e-4, view)
    g1, = torch.autograd.grad(loss1, whole_l)
    out[f"vocab_ce/rank{mesh.rank}"] = np.array([
        float(abs(loss - loss1)), float(abs(ce - ce1)),
        float((g - g1[..., lo:lo + n]).abs().max()), float(loss1)])
    table = torch.from_numpy(rng.normal(size=(v, 16)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, v, (b, s)))
    same = []
    for t in (table, table.to(torch.bfloat16)):
        got = layers.embed({"table": t[lo:lo + n]}, toks, view, v)
        same.append(torch.equal(got, t[toks].to(layers.ACT_DTYPE)))
    out[f"vocab_embed/rank{mesh.rank}"] = np.array(same)


def _repro_key(name: str):
    """(repro's path key, the index of the per-layer slice in its stacked
    leaf or None) of a port parameter: ``blocks.3.attn.wq.w`` ->
    ("blocks/attn/wq/w", (3,)), ``groups.1.selfs.0.attn.wq.w`` ->
    ("groups/selfs/attn/wq/w", (1, 0))."""
    parts = name.split(".")
    idx = tuple(int(p) for p in parts if p.isdigit())
    return "/".join(p for p in parts if not p.isdigit()), idx or None


def _layer(a, i):
    return np.ascontiguousarray(a if i is None else a[i])


@contextlib.contextmanager
def held_blocks(model):
    """Every leaf ``runtime.steps.PerBlock`` gathers inside the block (a
    new tensor, not this rank's block itself), by weakref: yields a
    record whose ``most`` is the most stacked blocks whose gathered
    leaves were alive at once, checked at each gather, and ``calls`` the
    gathers of stacked-block leaves."""
    import types
    import weakref

    from repro_torch.runtime import steps
    prefix = {f"{pre}.{rel}": pre for pre, blk in model.stacked_blocks()
              .items() for rel, _ in blk.named_parameters()}
    rec = types.SimpleNamespace(most=0, calls=0, alive=[])
    real = steps.PerBlock.leaf

    def leaf(self, name):
        t = real(self, name)
        pre = prefix.get(name)
        if pre is None:
            return t
        rec.calls += 1
        root = t if t._base is None else t._base
        if root.untyped_storage()._cdata != \
                self.params[name].untyped_storage()._cdata:
            rec.alive.append((pre, weakref.ref(root)))
        rec.alive = [(p, r) for p, r in rec.alive if r() is not None]
        rec.most = max(rec.most, len({p for p, _ in rec.alive}))
        return t
    steps.PerBlock.leaf = leaf
    try:
        yield rec
    finally:
        steps.PerBlock.leaf = real


def _same(a, b) -> list:
    """[bit-equal, max |a - b|] of two tensors."""
    import torch
    a, b = a.detach(), b.detach()
    return [bool(torch.equal(a, b)), float((a.float() - b.float()).abs()
                                           .max()) if a.numel() else 0.0]


def _per_block_rank(mesh, ref, out):
    """The PER_BLOCK cases on this rank ("per_block/{arch}/{what}/rank{r}":
    [bit-equal, max |difference|]; "/held": [the most blocks held at
    once, the gathers of block leaves])."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import build_model
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (model_shardings, shard_params,
                                            split_batch, tp_leaves,
                                            tp_pieces)
    r = mesh.rank
    for arch in PER_BLOCK_ARCHS:
        cfg = configs.get_reduced_config(arch)
        run = RunConfig(**dict(XATTN_KNOBS, ssm_chunk=LAST_CHUNK))
        model = build_model(cfg, "meta", trainable=True)
        sh = model_shardings(model, mesh)
        keep, pieces = tp_leaves(model, mesh), tp_pieces(model, mesh)
        full = port_model(arch, ref)
        params = shard_params({k: p.detach() for k, p in
                               full.named_parameters()}, sh)
        del full
        batch = xattn_batch(ref, arch, torch.from_numpy) \
            if arch in XATTN_ARCHS else {
                k: torch.from_numpy(ref[f"in/{arch}/{k}"])
                for k in ("tokens", "labels")}
        fwd = {k: v for k, v in batch.items() if k != "labels"}
        toks = batch["tokens"]
        tag = f"per_block/{arch}"
        held = []

        def whole_tree(axes, cast=False):
            p = steps.cast_params(params) if cast else params
            return steps._compute_tree(p, sh, axes, keep, pieces)
        # Prefill.
        with held_blocks(model) as h:
            got = steps.make_prefill_step(model, run, mesh)(params, fwd)
        held.append(h)
        view, rows = split_batch(mesh, fwd)
        with torch.inference_mode(), steps.bound(model, whole_tree(())):
            logits, _ = model.forward(run, rows, mesh=view)
            want = steps.gather_rows(view, steps._last_row(model, view,
                                                           logits))
        out[f"{tag}/prefill/rank{r}"] = np.array(_same(got, want))
        # The serve step's logits (as ``_last_row`` hands them on) and
        # cache against the model's decode on the whole tree.
        serve = steps.make_serve_step(model, run, mesh)
        cache = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        cache2 = steps.local_cache(model, mesh, TRAIN_B, DECODE_LEN, "cpu")
        seen, real_last = [], steps._last_row

        def last_row(m, v, lg):
            seen.append(lg.clone())
            return real_last(m, v, lg)
        tree = whole_tree(())
        for t in range(DECODE_STEPS):
            steps._last_row = last_row
            try:
                with held_blocks(model) as h:
                    _, cache = serve(params, toks[:, t:t + 1], cache)
            finally:
                steps._last_row = real_last
            held.append(h)
            view, rows = split_batch(mesh, {"tokens": toks[:, t:t + 1]})
            with torch.inference_mode(), steps.bound(model, tree):
                lg, cache2 = model.decode_step(run, rows["tokens"], cache2,
                                               mesh=view)
            out[f"{tag}/serve{t}/rank{r}"] = np.array(_same(seen[-1], lg))
        same = [_same(a, b) for (_, a), (_, b) in zip(
            steps._leaves(cache), steps._leaves(cache2))]
        out[f"{tag}/cache/rank{r}"] = np.array(
            [all(s for s, _ in same), max(d for _, d in same)])
        del tree
        # A train step's metrics and gradients under each remat.
        for p in params.values():
            p.requires_grad_(True)
        for remat in PER_BLOCK_REMATS:
            rr = dataclasses.replace(run, remat=remat)
            with held_blocks(model) as h:
                grads, metrics = steps.make_grad_fn(model, rr, mesh)(params,
                                                                    batch)
            held.append(h)
            view, rows = split_batch(mesh, batch)
            with steps.bound(model, whole_tree(view.batch_axes, cast=True)):
                logits, aux = model(rr, rows, mesh=view)
                loss, ce = steps.cross_entropy(logits, rows["labels"],
                                               rr.z_loss, view, cfg.vocab)
                want = {"ce": ce}
                if "lb_loss" in aux:
                    loss = loss + cfg.router_aux_coef * aux["lb_loss"]
                    want["lb_loss"] = aux["lb_loss"]
                    want["dropped"] = aux["dropped"].float()
                want["loss"] = loss
                g1 = torch.autograd.grad(loss, list(params.values()))
            for k, m in want.items():
                out[f"{tag}/{remat}/metrics/{k}/rank{r}"] = np.array(
                    _same(metrics[k], m))
            same = [_same(grads[k], g) for k, g in zip(params, g1)]
            out[f"{tag}/{remat}/grads/rank{r}"] = np.array(
                [all(s for s, _ in same), max(d for _, d in same),
                 len(same)])
        for p in params.values():
            p.requires_grad_(False)
        out[f"{tag}/held/rank{r}"] = np.array(
            [max(h.most for h in held), min(h.calls for h in held)])


def _restore_rank(mesh, ref, out, ckpt_dir):
    """Restore the checkpoint the (2, 4) ranks saved into this mesh's
    blocks; gather them whole."""
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import (gather_params, init_sharded,
                                            model_shardings)
    arch = TRAIN_ARCHS[0]
    model = build_model(configs.get_reduced_config(arch), "meta",
                        trainable=True)
    sh = model_shardings(model, mesh)
    params = init_sharded(model, sh, torch.Generator().manual_seed(9), "cpu")
    opt = adamw.init(params)
    CheckpointManager(ckpt_dir).restore(1, {"params": params, "opt": opt},
                                        {"params": sh,
                                         "opt": adamw.state_shardings(sh)})
    out["restored/step"] = opt.step.numpy()
    for tag, tree in (("p", params), ("m", opt.m), ("v", opt.v)):
        for k, v in gather_params(tree, sh).items():
            out[f"restored/{tag}/{k}"] = v.numpy()


def torch_rank(rank: int, world: int, init_file: str, ref_file: str,
               ckpt_dir: str, out_dir: str) -> None:
    """One gloo CPU rank: the (2, 4) cases with 8 ranks, the (1, 4)
    restore and the (2, 2) PER_BLOCK cases with 4; rank 0 writes
    ``out_dir/world{world}.npz``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        with np.load(ref_file) as z:
            ref = {k: z[k] for k in z.files}
        out = {}
        if world == 8:
            mesh = make_mesh(MESH, AXES)
            _moe_rank(mesh, ref, out)
            _tp_rank(mesh, out)
            _train_rank(mesh, ref, out, ckpt_dir, out_dir)
            _steps_rank(mesh, ref, out, out_dir)
            _xattn_rank(mesh, ref, out)
            _last_rank(mesh, ref, out, out_dir)
            _sp_rank(mesh, ref, out)
            _dryrun_rank(mesh, ref, out)
            x = torch.arange(24.0).reshape(2, 3, 4) + rank
            for dim in range(3):
                g = mesh.all_gather(x, AXES, dim)
                out[f"contiguous/{dim}"] = np.array([
                    g.is_contiguous(),
                    mesh.psum_scatter(g, AXES, dim).is_contiguous()])
        else:
            mesh = make_mesh((1, 4), AXES)
            _restore_rank(mesh, ref, out, ckpt_dir)
            _per_block_rank(make_mesh(PER_BLOCK_MESH, AXES), ref, out)
        out["routes"] = np.array(sorted(mesh.routes.items()))
        blocks = {k: v for k, v in out.items() if "/rank" in k}
        gathered = [None] * world
        dist.all_gather_object(gathered, blocks)
        if rank == 0:
            for b in gathered:
                out.update(b)
            np.savez(os.path.join(out_dir, f"world{world}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, args: tuple, timeout: float) -> None:
    """``sharded_pair.spawn_ranks`` over this module's ``torch_rank``."""
    import sharded_pair
    sharded_pair.spawn_ranks(world, args, timeout, target=torch_rank)
