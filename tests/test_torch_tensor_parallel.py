"""The tensor-parallel layout of the port's families
(``sharding.rules.tp_layout`` / ``tp_block`` / ``tp_leaves`` /
``tp_pieces``, ``runtime.steps.local_cache``) at full width, shapes only:
no ranks, no weights (meta-device models and meshes of names and sizes).

For each of Qwen1.5-0.5B, MiniCPM-2B, Nemotron-4-15B, Yi-9B,
Mixtral-8x7B, Llama-3.2-Vision-90B, SeamlessM4T-medium, DeepSeek-V2,
Zamba2-1.2B and xLSTM-1.3B on ``make_production_mesh``'s two shapes and
on (2, 4):

* the layout (a rank's q heads, kv heads, FFN width, vocab, shared
  experts' width and Mamba2 heads) against the config's counts split
  where "model" divides them (the kv heads only where the q heads split
  too), and the leaves that stay blocks: exactly those whose ``repro``
  spec (``repro.sharding.rules.spec_pspec`` on the stacked leaf, a stub
  mesh) puts that count on "model", their block shapes the layout's
  counts; the re-blocked leaves (MLA's ``wuq``, Mamba2's ``in_proj``)
  exactly where their field splits, their piece's width the layout's;
* ``local_cache``'s leaf shapes (built on the meta device) against the
  blocks of ``repro``'s ``cache_shardings`` over ``repro``'s cache tree,
  compared leaf by leaf as ``test_cache_specs_match_repro`` compares
  specs, at a batch the batch axes divide (64) and one they do not (3);
  the recurrent state leaves by the rule the port keeps instead (its
  heads: ``S`` and ``C`` as many elements as ``repro``'s blocks, ``conv``
  its x channels and the B / C ones whole; ROADMAP §3).  The batch 64
  matches no other cache dimension of these configs (``repro``'s rule
  splits the first dimension equal to the batch: at a batch equal to an
  earlier dimension, such as the vlm's 4 self layers a group or its 20
  groups, it splits that one, pinned as a fact about the reference;
  ``local_cache`` splits the rows).

The attention leaves match under any attention prefix: the self blocks'
and the vlm's cross blocks' ``attn.*``, the encdec decoder's ``self.*``
and ``cross.*``, zamba2's shared block's and DeepSeek-V2's dense layer's
``attn.*``.  Every leaf stays whole on a mesh without a "model" extent.
Exact throughout.
"""
import dataclasses
import math

import jax
import pytest

import mesh_model_pair as pair
from repro import configs as j_configs
from repro.models.model import build_model as j_build_model
from repro.sharding import rules as j_rules
from repro_torch import configs
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.runtime import steps
from repro_torch.sharding import rules

TP_ARCHS = ("qwen1.5-0.5b", "minicpm-2b", "nemotron-4-15b", "yi-9b",
            "mixtral-8x7b", "llama-3.2-vision-90b", "seamless-m4t-medium",
            "deepseek-v2-236b", "zamba2-1.2b", "xlstm-1.3b")
# The recurrent state leaves: the port splits their heads (ROADMAP §3).
STATE_KEYS = ("S", "C", "n", "m", "c", "h", "conv")
KINDS = ("multi", "single", "test")      # the production meshes, (2, 4)
CACHE_BATCHES, CACHE_LEN = (64, 3), 1024
# Leaf suffix -> (layout field, the dimension it splits); the attention's
# under each of its prefixes.
LEAVES = {**{f"{pre}.{k}": v for pre in ("attn", "self", "cross")
             for k, v in {"wq.w": ("heads", 1), "wq.b": ("heads", 0),
                          "wo.w": ("heads", 0), "wk.w": ("kv_heads", 1),
                          "wk.b": ("kv_heads", 0), "wv.w": ("kv_heads", 1),
                          "wv.b": ("kv_heads", 0)}.items()},
          "attn.wuk.w": ("heads", 1), "attn.wuv.w": ("heads", 1),
          "ffn.w_gate.w": ("ffn", 1), "ffn.w_up.w": ("ffn", 1),
          "ffn.w_down.w": ("ffn", 0),
          **{f"moe.shared.{k}": ("shared_ffn", 1 if k != "w_down.w" else 0)
             for k in ("w_gate.w", "w_up.w", "w_down.w")},
          "out_proj.w": ("ssm_heads", 0), "lora.b_q": ("heads", 1),
          "embed.table": ("vocab", 0), "unembed.w": ("vocab", 1)}
# The xLSTM's leaves (no attention prefix; the sLSTM's wo is its o gate's
# input projection too, a whole leaf: the layout splits none of it).
XLSTM_LEAVES = {"slstm.wo.w": None,
                **{k: ("heads", 1) for k in ("wq.w", "wk.w", "wv.w",
                                             "wo_gate.w")},
                **{f"slstm.w{g}.w": ("heads", 1) for g in "zif"},
                **{f"slstm.w{g}.b": ("heads", 0) for g in "zif"},
                "wo.w": ("heads", 0), "embed.table": ("vocab", 0),
                "unembed.w": ("vocab", 1)}
# Re-blocked leaves: repro's block is not the one the rank computes on.
PIECES = {"attn.wuq.w": "heads", "in_proj.w": "ssm_heads"}


class StubMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _mesh(kind):
    if kind == "test":
        return AbstractMesh((2, 4), ("data", "model"))
    return make_production_mesh(multi_pod=kind == "multi")


def _expected(cfg, m):
    """The layout the rule gives, from the counts alone."""
    def cut(n):
        return n // m if n % m == 0 else n
    heads = cut(cfg.n_heads)
    kv = cut(cfg.n_kv_heads) if heads < cfg.n_heads else cfg.n_kv_heads
    ssm = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim \
        if cfg.family == "ssm_hybrid" else 0
    return rules.TPLayout(heads, kv, cut(cfg.d_ff), cut(cfg.vocab),
                          cut(cfg.d_ff_expert * cfg.n_shared_experts),
                          cut(ssm))


def _leaf(name, table):
    bare = ".".join(s for s in name.split(".") if not s.isdigit())
    return next((v for k, v in table.items()
                 if bare.endswith("." + k) or bare == k), None)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_layout_and_blocks(arch, kind):
    mesh = _mesh(kind)
    m = mesh.shape["model"]
    cfg = configs.get_config(arch)
    lay = rules.tp_layout(cfg, mesh)
    assert lay == _expected(cfg, m)
    stub = StubMesh(tuple(mesh.shape.values()), mesh.axis_names)
    jspecs = pair.flat(j_build_model(j_configs.get_config(arch)).specs)
    model = build_model(cfg, "meta")
    keep = rules.tp_leaves(model, mesh)
    pieces = rules.tp_pieces(model, mesh, index=1)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    whole = rules.tp_whole(cfg)
    table = XLSTM_LEAVES if cfg.family == "xlstm" else LEAVES
    for name in shapes:
        field = _leaf(name, PIECES)
        split = field and getattr(lay, field) < getattr(whole, field)
        assert (name in pieces) == bool(split), name
        if split:
            # The piece: this rank's heads' columns (all but B / C).
            dim, ranges = pieces[name]
            width = sum(b - a for a, b in ranges)
            if field == "heads":
                assert width * m == shapes[name][dim]
            else:
                n = 2 * cfg.ssm_state
                assert (width - n) * m == shapes[name][dim] - n
            assert name not in keep
        kind_ = _leaf(name, table)
        if kind_ is None:
            assert name not in keep, name
            continue
        field, dim = kind_
        split = getattr(lay, field) < getattr(whole, field)
        assert (name in keep) == split, name
        jname = "/".join(s for s in name.split(".") if not s.isdigit())
        jspec = tuple(j_rules.spec_pspec(jspecs[jname], stub))
        lead = len(jspec) - len(shapes[name])
        if split:
            # repro's rule puts this dimension on "model" ...
            assert jspec[lead + dim] == "model", (name, jspec)
            # ... and the block holds the layout's count of it.
            per = shapes[name][dim] // getattr(whole, field)
            assert shapes[name][dim] // m == per * getattr(lay, field)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_local_cache_is_repro_cache_blocks(arch, kind):
    """Every cache leaf the block ``repro``'s ``cache_shardings`` gives,
    but the recurrent state's: the port splits its heads where the layout
    does (``repro`` the widest divisible trailing axis), so ``S`` and
    ``C`` hold as many elements as ``repro``'s block, at the heads axis;
    ``conv`` its x channels of di / m and the 2 N B / C ones; the other
    state leaves (which ``repro`` keeps whole) 1 / m of them; all whole
    over "model" where the layout keeps the heads whole (the xLSTM's 4
    on a 16-way axis)."""
    mesh = _mesh(kind)
    m = mesh.shape["model"]
    jmesh = jax.sharding.AbstractMesh(tuple(mesh.shape.values()),
                                      mesh.axis_names)
    cfg = configs.get_config(arch)
    tmodel = build_model(cfg, "meta")
    jmodel = j_build_model(j_configs.get_config(arch))
    lay, whole = rules.tp_layout(cfg, mesh), rules.tp_whole(cfg)
    field = "ssm_heads" if cfg.family == "ssm_hybrid" else "heads"
    split = getattr(lay, field) < getattr(whole, field)
    for b in CACHE_BATCHES:
        got = pair.flat(steps.local_cache(tmodel, mesh, b, CACHE_LEN,
                                          "meta"))
        specs = jmodel.cache_specs(b, CACHE_LEN)
        want = pair.flat(j_rules.cache_shardings(jmesh, specs, b))
        jshape = pair.flat(jax.tree.map(lambda a: tuple(a.shape), specs))
        rows = pair.flat(steps.local_cache(
            tmodel, AbstractMesh(tuple(mesh.shape.values())[:-1],
                                 mesh.axis_names[:-1]), b, CACHE_LEN,
            "meta"))
        assert set(got) == set(want)
        for k, sh in want.items():
            block = tuple(
                d // (1 if p is None else rules.mesh_extent(
                    mesh, (p,) if isinstance(p, str) else tuple(p)))
                for d, p in zip(jshape[k], tuple(sh.spec)
                                + (None,) * len(jshape[k])))
            assert got[k].device.type == "meta"
            if k.rsplit("/", 1)[-1] not in STATE_KEYS:
                assert tuple(got[k].shape) == block, (arch, kind, b, k)
                continue
            # The state leaf of this rank's rows, whole over "model".
            full = tuple(rows[k].shape)
            if not split:
                assert tuple(got[k].shape) == full, (arch, kind, b, k)
            elif k.endswith("conv"):
                di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
                assert tuple(got[k].shape) == full[:-1] + (
                    di // m + 2 * n,), (arch, kind, b, k)
            else:
                cut = [i for i, (g, f) in enumerate(zip(got[k].shape, full))
                       if g != f]
                assert len(cut) == 1 and got[k].shape[cut[0]] * m == \
                    full[cut[0]], (arch, kind, b, k)
                if k.rsplit("/", 1)[-1] in ("S", "C"):
                    assert got[k].numel() == math.prod(block), (k, block)


@pytest.mark.parametrize("kind", KINDS)
def test_mla_splits_its_heads_and_reblocks_wuq(kind):
    """DeepSeek-V2 (MLA): 128 heads split 4 or 16 ways; ``wuk`` / ``wuv``
    keep their head columns and ``wo`` its head rows as blocks (the
    layout's count, 8 or 32 heads a rank), the shared experts' width and
    the dense layer's GQA and FFN split too; ``wuq``, whose ``repro`` spec
    gives "model" to its q_lora rows, is re-blocked: gathered and cut to
    its heads' columns; ``wdq`` / ``wdkv`` / ``wkr`` and the latents'
    norms stay whole; its ``ckv`` / ``kr`` cache whole over "model"."""
    mesh = _mesh(kind)
    m = mesh.shape["model"]
    cfg = configs.get_config("deepseek-v2-236b")
    lay = rules.tp_layout(cfg, mesh)
    assert lay.heads == cfg.n_heads // m and lay.kv_heads == lay.heads
    assert lay.shared_ffn == cfg.d_ff_expert * cfg.n_shared_experts // m
    model = build_model(cfg, "meta")
    keep = rules.tp_leaves(model, mesh)
    sh = rules.model_shardings(model, mesh)
    for leaf in ("wuk.w", "wuv.w", "wo.w"):
        assert f"blocks.0.attn.{leaf}" in keep
    for leaf in ("wdq.w", "wdkv.w", "wkr.w", "q_norm.scale",
                 "kv_norm.scale", "wuq.w"):
        assert f"blocks.0.attn.{leaf}" not in keep, leaf
    assert "blocks.0.moe.shared.w_down.w" in keep
    assert "dense_blocks.0.attn.wq.w" in keep
    assert tuple(sh["blocks.0.attn.wuq.w"].spec)[0] == "model"
    w = cfg.qk_nope_dim + cfg.qk_rope_dim
    for i in range(m):
        assert rules.tp_pieces(model, mesh, index=i)[
            "blocks.0.attn.wuq.w"] == (1, ((i * lay.heads * w,
                                            (i + 1) * lay.heads * w),))
    cache = steps.local_cache(model, mesh, 64, CACHE_LEN, "meta")
    assert cache["ckv"].shape[-1] == cfg.kv_lora
    assert cache["dense_k"].shape[-2] == lay.kv_heads


@pytest.mark.parametrize("kind", KINDS)
def test_model_free_meshes_stay_whole(kind):
    """A ("data",) mesh (no "model" extent) keeps every leaf of all ten
    configs whole: the layout whole, no block, no re-blocked piece, the
    cache whole over heads."""
    mesh = _mesh(kind)
    data = AbstractMesh((mesh.size,), ("data",))
    for arch in configs.ARCH_NAMES:
        c = configs.get_config(arch)
        assert rules.tp_layout(c, data) == rules.tp_whole(c)
        model = build_model(c, "meta")
        assert not rules.tp_leaves(model, data)
        assert not rules.tp_pieces(model, data, index=0)


@pytest.mark.parametrize("kind", ("multi", "single"))
def test_xlstm_quarter_heads_stay_whole(kind):
    """xLSTM-1.3B's 4 heads on the 16-way production axis: ``repro``'s
    spec puts its ``wq`` columns (2,048) on "model", cutting each head in
    quarters; the port keeps those leaves whole (the layout's heads do not
    divide) while its vocab of 50,304 splits, and its state stays whole
    over "model"."""
    mesh = _mesh(kind)
    stub = StubMesh(tuple(mesh.shape.values()), mesh.axis_names)
    cfg = configs.get_config("xlstm-1.3b")
    jspecs = pair.flat(j_build_model(j_configs.get_config(
        "xlstm-1.3b")).specs)
    assert tuple(j_rules.spec_pspec(jspecs["groups/mlstms/wq/w"],
                                    stub))[-1] == "model"
    lay = rules.tp_layout(cfg, mesh)
    assert lay.heads == cfg.n_heads and lay.vocab == cfg.vocab // 16
    keep = rules.tp_leaves(build_model(cfg, "meta"), mesh)
    assert "groups.0.mlstms.0.wq.w" not in keep
    assert "groups.0.slstm.wz.w" not in keep
    assert {"embed.table", "unembed.w"} <= keep


def test_straddling_q_heads_raise():
    """A layout whose ranks' q heads would straddle two kv heads (6 heads
    in 2 groups on a 3-way axis) raises instead of computing whole."""
    cfg = dataclasses.replace(configs.get_reduced_config("nemotron-4-15b"),
                              n_heads=6, n_kv_heads=2)
    with pytest.raises(ValueError, match="straddle"):
        rules.tp_layout(cfg, AbstractMesh((1, 3), ("data", "model")))


def test_reduced_configs_on_the_test_mesh():
    """The reduced configs the CPU ranks run on (2, 4) cover every case of
    the rule: q heads split one a rank with kv heads split (qwen) or whole
    (mixtral, yi), q heads whole (MiniCPM's 6, Nemotron's 6), the FFN, the
    shared experts, the Mamba2 heads and the vocab split."""
    mesh = _mesh("test")
    got = {a: rules.tp_layout(configs.get_reduced_config(a), mesh)
           for a in TP_ARCHS}
    assert got["qwen1.5-0.5b"] == rules.TPLayout(1, 1, 44, 128)
    assert got["mixtral-8x7b"] == rules.TPLayout(1, 2, 40, 128)
    assert got["yi-9b"] == rules.TPLayout(1, 2, 44, 128)
    assert got["minicpm-2b"] == rules.TPLayout(6, 6, 45, 128)
    assert got["nemotron-4-15b"] == rules.TPLayout(6, 2, 96, 128)
    # q heads split one a rank, the 2 kv heads whole (head j reads kv
    # head j // 2), self and cross alike.
    assert got["llama-3.2-vision-90b"] == rules.TPLayout(1, 2, 44, 128)
    assert got["seamless-m4t-medium"] == rules.TPLayout(1, 1, 64, 128)
    # MLA's 4 heads one a rank, the shared experts' 96 split; zamba2's 8
    # Mamba2 heads two a rank, its shared block's 4 heads one; the
    # xLSTM's 4 heads one a rank (it has no FFN).
    assert got["deepseek-v2-236b"] == rules.TPLayout(1, 1, 40, 128, 24)
    assert got["zamba2-1.2b"] == rules.TPLayout(1, 1, 64, 128, 0, 2)
    assert got["xlstm-1.3b"] == rules.TPLayout(1, 1, 0, 128)


@pytest.mark.parametrize("kind", KINDS)
def test_encdec_decoder_leaves_split_and_its_head_stays_whole(kind):
    """SeamlessM4T-medium: the decoder's ``self.*`` and ``cross.*``
    attention leaves and the encoder's ``attn.*`` are blocks over
    "model" (16 heads split 4 or 16 ways, kv heads too), the FFNs too;
    its vocab of 256,206 divides by neither 4 nor 16, so the embedding and
    the unembedding stay whole, as ``repro``'s spec leaves them."""
    mesh = _mesh(kind)
    m = mesh.shape["model"]
    cfg = configs.get_config("seamless-m4t-medium")
    assert cfg.vocab % m
    model = build_model(cfg, "meta")
    keep = rules.tp_leaves(model, mesh)
    for i in range(cfg.n_layers):
        for pre in ("self", "cross"):
            for leaf in ("wq", "wk", "wv", "wo"):
                assert f"dec_blocks.{i}.{pre}.{leaf}.w" in keep
        assert f"dec_blocks.{i}.ffn.w_up.w" in keep
        assert f"dec_blocks.{i}.self_norm.scale" not in keep
    for i in range(cfg.enc_layers):
        assert f"enc_blocks.{i}.attn.wq.w" in keep
    assert "embed.table" not in keep and "unembed.w" not in keep
    stub = StubMesh(tuple(mesh.shape.values()), mesh.axis_names)
    jspecs = pair.flat(j_build_model(j_configs.get_config(
        "seamless-m4t-medium")).specs)
    for name in ("embed/table", "unembed/w"):
        assert "model" not in tuple(j_rules.spec_pspec(jspecs[name], stub))


def test_repro_cache_rule_takes_the_first_axis_of_the_batch_size():
    """``repro``'s ``cache_shardings`` puts "data" on the first cache
    dimension equal to the batch: the vlm's self cache is [20 groups, 4
    self layers a group, B, T, 8, 128], so at batch 4 on (2, 4) it splits
    the layers a group and at batch 20 the groups, not the rows (a fact
    about the reference, pinned).  ``local_cache`` takes the rows: this
    rank's B / 2 of them, and 2 of the 8 kv heads in each kv leaf."""
    mesh = _mesh("test")
    jmesh = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    arch = "llama-3.2-vision-90b"
    cfg = configs.get_config(arch)
    jmodel = j_build_model(j_configs.get_config(arch))
    tmodel = build_model(cfg, "meta")
    for b, axis in ((4, 1), (20, 0)):
        specs = pair.flat(j_rules.cache_shardings(
            jmesh, jmodel.cache_specs(b, CACHE_LEN), b))
        assert tuple(specs["k"].spec)[axis] == "data", (b, specs["k"])
        assert tuple(specs["k"].spec)[2] is None
        got = steps.local_cache(tmodel, mesh, b, CACHE_LEN, "meta")
        assert tuple(got["k"].shape) == (20, 4, b // 2, CACHE_LEN, 2, 128)
        assert tuple(got["img_k"].shape) == (20, b // 2, 1600, 2, 128)
    # The reduced vlm's 2 groups: at batch 2, the groups.
    red = j_build_model(j_configs.get_reduced_config(arch))
    specs = pair.flat(j_rules.cache_shardings(jmesh, red.cache_specs(2, 8),
                                              2))
    assert tuple(specs["k"].spec)[0] == "data"
