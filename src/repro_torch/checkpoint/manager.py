"""Async, atomically-committed checkpointing in ``repro``'s on-disk format
(port of src/repro/checkpoint/manager.py).

Layout:  <dir>/step_<N:08d>/arrays.npz + meta.json, committed via tmp-dir
rename (a partially-written checkpoint is never visible).  The arrays are
keyed by ``repro``'s pytree paths, so a checkpoint written by either
package restores in the other:

  * a tree is a nested dict whose leaves are tensors, or an
    ``OptState``-like NamedTuple (field ``step`` -> path segment
    ``.step``, as ``jax.tree_util`` spells a NamedTuple field);
  * a dict key may be a dotted parameter name (``blocks.3.attn.wq.w``,
    the port's per-layer layout): its integer segments are layer indices,
    and the layers of one path are stacked along a leading axis, as
    ``repro`` stacks its blocks (``params/blocks/attn/wq/w`` [L, ...]).

So ``{"params": dict(model.named_parameters()), "opt": opt_state}`` of
a training model saves the same 46 keys of the reduced Qwen tree that
``repro`` writes, with ``repro``'s dtypes (f32 params and moments, an
int32 step).

``save`` copies to the host in the caller (before the next step's
in-place update can touch the tensors), then writes on a background
thread; ``wait()`` drains and raises what the write raised.  ``keep``
bounds disk usage.  ``restore`` writes into the live tensors of
``like_tree`` in place (casting to each tensor's dtype) and returns it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch


def _entries(tree, path=()):
    """[(key, layer index tuple, tensor)] of a tree (see the module doc)."""
    if isinstance(tree, torch.Tensor):
        return [("/".join(p for p in path if not p.isdigit()),
                 tuple(int(p) for p in path if p.isdigit()), tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}",) for f in tree._fields]
        values = [getattr(tree, f) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [tuple(str(k).split(".")) for k in tree]
        values = list(tree.values())
    else:
        raise TypeError(f"checkpoint tree leaf at {'/'.join(path)} is a "
                        f"{type(tree).__name__}, not a tensor")
    out = []
    for segs, v in zip(items, values):
        out += _entries(v, path + segs)
    return out


def _flatten(tree) -> dict:
    """{key: [(layer index tuple, tensor), ...] in index order}; a key's
    indices must fill a grid (0..n-1 on each axis)."""
    flat: dict = {}
    for key, idx, t in _entries(tree):
        flat.setdefault(key, []).append((idx, t))
    for key, parts in flat.items():
        parts.sort(key=lambda e: e[0])
        idx = [i for i, _ in parts]
        if idx != [()] and idx != sorted(
                set(np.ndindex(*np.max(idx, axis=0) + 1))):
            raise ValueError(f"{key}: layer indices {idx[:4]}... do not "
                             f"fill a grid")
    return flat


def _to_host(parts) -> np.ndarray:
    """A host copy (never a view of a CPU tensor that the next step
    updates in place)."""
    if parts[0][0] == ():
        return parts[0][1].detach().to("cpu", copy=True).numpy()
    stacked = torch.stack([t.detach() for _, t in parts])
    shape = tuple(np.max([i for i, _ in parts], axis=0) + 1)
    return stacked.reshape(shape + stacked.shape[1:]).cpu().numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, extra_meta: Optional[dict] = None):
        host = {k: _to_host(parts) for k, parts in _flatten(tree).items()}
        meta = {"step": int(step), "keys": sorted(host.keys())}
        meta.update(extra_meta or {})
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write_async(self, step: int, host: dict, meta: dict):
        try:
            self._write(step, host, meta)
        except BaseException as e:      # noqa: BLE001 — re-raised in wait()
            self._error = e

    def _write(self, step: int, host: dict, meta: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic commit
        self._gc()

    def wait(self):
        """Wait for the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, like_tree):
        """Write checkpoint ``step`` into the tensors of ``like_tree`` in
        place and return it.  Its keys must be the checkpoint's and every
        shape must agree, or ``KeyError`` / ``ValueError`` is raised
        before anything is written."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            host = {k: z[k] for k in z.files}
        flat = _flatten(like_tree)
        if set(flat) != set(host):
            raise KeyError(f"checkpoint keys differ from the tree's: "
                           f"{sorted(set(flat) ^ set(host))[:5]}")
        for key, parts in flat.items():
            for idx, t in parts:
                if host[key][idx].shape != tuple(t.shape):
                    raise ValueError(
                        f"{key}{list(idx)}: checkpoint shape "
                        f"{host[key][idx].shape} != {tuple(t.shape)}")
        for key, parts in flat.items():
            for idx, t in parts:
                t.copy_(torch.from_numpy(np.asarray(host[key][idx])))
        return like_tree

    def meta(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "meta.json")
        with open(path) as f:
            return json.load(f)
