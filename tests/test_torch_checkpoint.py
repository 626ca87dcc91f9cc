"""The port's checkpoints (src/repro_torch/checkpoint/manager.py) are
``repro``'s: a checkpoint of the port's trainable reduced qwen and its
AdamW state restores through ``repro.checkpoint.manager`` into
``repro``'s param tree and ``OptState``, and one ``repro`` wrote restores
into the port's live tensors, with equal arrays (exact: both sides are
f32 params and moments and an int32 step, copied, never computed);
the same state saved by both gives the same npz keys, dtypes and values
and the same ``meta.json``.  Also ``keep``-bounded GC, no ``.tmp`` visible
after an async save, ``restore``'s refusals, and ``restore`` reading
each member through a memory map (or whole, where it is compressed).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models.model import build_model as j_build_model
from repro.models.module import init_params as j_init_params
from repro.optim import adamw as j_adamw
from repro_torch import configs
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import module
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

ARCH = "qwen1.5-0.5b"


def _stateful(seed):
    """The port's trainable reduced qwen with random weights from
    ``seed`` and an AdamW state holding random moments at step 7."""
    cfg = configs.get_reduced_config(ARCH)
    model = build_model(cfg, "cpu", trainable=True)
    gen = torch.Generator().manual_seed(seed)
    module.params_from_numpy(model, module.init_params(model.specs, gen,
                                                       "cpu"))
    params = dict(model.named_parameters())
    opt = adamw.init(params)
    with torch.no_grad():
        for k in params:
            opt.m[k].normal_(generator=gen)
            opt.v[k].uniform_(generator=gen)
        opt.step.fill_(7)
    return model, params, opt


def _repro_tree(params, opt):
    """The port's state as repro's tree: stacked blocks, OptState."""
    def nest(flat):
        out = {}
        for name, t in flat.items():
            parts = name.split(".")
            if parts[0] == "blocks":
                parts = ["blocks"] + parts[2:]
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d.setdefault(parts[-1], []).append(t.detach().numpy())
        return jax.tree.map(lambda ts: jnp.asarray(np.stack(ts)) if
                            len(ts) > 1 else jnp.asarray(ts[0]), out,
                            is_leaf=lambda x: isinstance(x, list))
    return {"params": nest(params),
            "opt": j_adamw.OptState(jnp.int32(int(opt.step)), nest(opt.m),
                                    nest(opt.v))}


def _assert_state_equal(tree, params, opt):
    want = _repro_tree(params, opt)
    flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def _load(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        return arrays, json.load(f)


def test_port_checkpoint_restores_in_repro(tmp_path):
    _, params, opt = _stateful(0)
    CheckpointManager(str(tmp_path), async_save=False).save(
        7, {"params": params, "opt": opt})
    jm = j_build_model(j_configs.get_reduced_config(ARCH))
    jp = j_init_params(jm.specs, jax.random.key(1))
    back = JManager(str(tmp_path)).restore(7, {"params": jp,
                                               "opt": j_adamw.init(jp)})
    _assert_state_equal(back, params, opt)


def test_repro_checkpoint_restores_in_the_port(tmp_path):
    _, params, opt = _stateful(0)
    JManager(str(tmp_path), async_save=False).save(
        7, _repro_tree(params, opt))
    model, params2, opt2 = _stateful(1)
    live = {"params": params2, "opt": opt2}
    assert CheckpointManager(str(tmp_path)).restore(7, live) is live
    for k in params:
        assert params2[k] is dict(model.named_parameters())[k]  # in place
        assert torch.equal(params2[k], params[k]), k
        assert torch.equal(opt2.m[k], opt.m[k]) and torch.equal(
            opt2.v[k], opt.v[k]), k
    assert opt2.step.dtype == torch.int32 and int(opt2.step) == 7


def test_same_files_as_repro(tmp_path):
    """The same state saved by both: equal npz keys (the 46 of the reduced
    qwen tree), dtypes and arrays, and equal meta.json."""
    _, params, opt = _stateful(0)
    extra = {"arch": ARCH, "tokens_seen": 1234}
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        7, {"params": params, "opt": opt}, extra_meta=extra)
    JManager(str(tmp_path / "repro"), async_save=False).save(
        7, _repro_tree(params, opt), extra_meta=extra)
    got, got_meta = _load(str(tmp_path / "port" / "step_00000007"))
    want, want_meta = _load(str(tmp_path / "repro" / "step_00000007"))
    assert len(want) == 46 and set(got) == set(want)
    assert "params/blocks/attn/wq/w" in got and "opt/.step" in got
    assert "opt/.m/blocks/ffn/w_down/w" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    assert got["opt/.step"].dtype == np.int32
    assert got_meta == want_meta


def test_keep_bounds_the_checkpoints(tmp_path):
    _, params, opt = _stateful(0)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, {"params": params, "opt": opt})
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    assert mgr.meta(30)["step"] == 30


def test_async_save_leaves_no_partial_checkpoint(tmp_path):
    """The async save copies to the host in the caller: an in-place
    update right after ``save`` does not reach the file."""
    _, params, opt = _stateful(0)
    before = {k: p.detach().clone() for k, p in params.items()}
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(5, {"params": params, "opt": opt})
    with torch.no_grad():
        for p in params.values():
            p.add_(1.0)
    mgr.wait()
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert mgr.latest_step() == 5
    mgr.restore(5, {"params": params, "opt": opt})
    assert all(torch.equal(params[k], before[k]) for k in params)


def test_restore_refuses_another_tree(tmp_path):
    _, params, opt = _stateful(0)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": params, "opt": opt})
    fewer = dict(params)
    fewer.pop("embed.table")
    with pytest.raises(KeyError, match="params/embed/table"):
        mgr.restore(1, {"params": fewer, "opt": opt})
    wider = build_model(configs.get_reduced_config("yi-9b"), "cpu",
                        trainable=True)
    wp = dict(wider.named_parameters())
    with pytest.raises((KeyError, ValueError)):
        mgr.restore(1, {"params": wp, "opt": adamw.init(wp)})
    assert all(not torch.isnan(p).any() for p in params.values())


def test_restore_maps_the_members_it_reads(tmp_path, monkeypatch):
    """``restore`` memory-maps each member of the uncompressed npz, so a
    rank reads only the pages of its own slices: every mapped member
    equals ``np.load``'s array, and the restore runs with the npz's
    whole-array reads refused."""
    _, params, opt = _stateful(0)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, {"params": params, "opt": opt})
    path = str(tmp_path / "step_00000003" / "arrays.npz")
    members = manager._npz_members(path)
    with np.load(path) as z:
        assert set(members) == set(z.files)
        for k in z.files:
            shape, dtype, offset = members[k]
            assert offset is not None, k
            mapped = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                               shape=shape)
            assert mapped.dtype == z[k].dtype and np.array_equal(
                mapped, z[k]), k

    def refuse(self, key):
        raise AssertionError(f"{key} read whole")
    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", refuse)
    _, params2, opt2 = _stateful(1)
    mgr.restore(3, {"params": params2, "opt": opt2})
    for k in params:
        assert torch.equal(params2[k], params[k]), k
        assert torch.equal(opt2.m[k], opt.m[k]) and torch.equal(
            opt2.v[k], opt.v[k]), k
    assert int(opt2.step) == 7


def test_restore_reads_a_compressed_checkpoint(tmp_path):
    """An npz whose members are compressed cannot be mapped: each is read
    whole, to the same state."""
    _, params, opt = _stateful(0)
    CheckpointManager(str(tmp_path / "a"), async_save=False).save(
        3, {"params": params, "opt": opt})
    arrays, meta = _load(str(tmp_path / "a" / "step_00000003"))
    step = tmp_path / "b" / "step_00000003"
    os.makedirs(step)
    np.savez_compressed(step / "arrays.npz", **arrays)
    with open(step / "meta.json", "w") as f:
        json.dump(meta, f)
    members = manager._npz_members(str(step / "arrays.npz"))
    assert all(offset is None for _, _, offset in members.values())
    _, params2, opt2 = _stateful(1)
    CheckpointManager(str(tmp_path / "b")).restore(
        3, {"params": params2, "opt": opt2})
    for k in params:
        assert torch.equal(params2[k], params[k]), k
        assert torch.equal(opt2.v[k], opt.v[k]), k
    assert int(opt2.step) == 7
