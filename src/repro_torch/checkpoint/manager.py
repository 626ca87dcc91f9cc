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

Under a mesh the tensors are this rank's blocks, and ``shardings`` (a
tree of ``sharding.rules.NamedSharding`` shaped like the state) says
where each lies.  ``save`` keeps the format mesh-agnostic, as ``repro``
does: each leaf is all-gathered whole one layer's part at a time (every
rank, in one order) and copied to rank 0's host at once, so a card holds
one whole part beside its blocks; rank 0 writes, and ``wait`` is also a
barrier (every rank waits for rank 0's commit, and all raise if the
write failed).  Rank 0's host holds the whole state until the write
ends, as ``repro``'s ``device_get`` does.  ``restore`` lets each rank
read only its own block of each array (the shapes are checked first,
from the npz headers, then each member is memory-mapped: ``np.savez``
stores them uncompressed), so a save on (2, 4) restores on (1, 4), on
one process, or on any mesh whose extents divide the shapes.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.sharding.rules import NamedSharding, gather_full, \
    mesh_of, shard_slices


def _entries(tree, path=(), leaf=torch.Tensor):
    """[(key, layer index tuple, tensor)] of a tree (see the module doc);
    ``leaf`` is the leaves' type (``NamedSharding`` for a sharding
    tree)."""
    if isinstance(tree, leaf):
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
                        f"{type(tree).__name__}, not a {leaf.__name__}")
    out = []
    for segs, v in zip(items, values):
        out += _entries(v, path + segs, leaf)
    return out


def _flatten(tree, leaf=torch.Tensor) -> dict:
    """{key: [(layer index tuple, tensor), ...] in index order}; a key's
    indices must fill a grid (0..n-1 on each axis)."""
    flat: dict = {}
    for key, idx, t in _entries(tree, (), leaf):
        flat.setdefault(key, []).append((idx, t))
    for key, parts in flat.items():
        parts.sort(key=lambda e: e[0])
        idx = [i for i, _ in parts]
        if idx != [()] and idx != sorted(
                set(np.ndindex(*np.max(idx, axis=0) + 1))):
            raise ValueError(f"{key}: layer indices {idx[:4]}... do not "
                             f"fill a grid")
    return flat


def _shardings(tree, shardings) -> Optional[dict]:
    """{key: [(layer index, NamedSharding)]} matching ``_flatten(tree)``."""
    if shardings is None:
        return None
    flat = _flatten(shardings, NamedSharding)
    want = {k: [i for i, _ in v] for k, v in _flatten(tree).items()}
    if {k: [i for i, _ in v] for k, v in flat.items()} != want:
        raise KeyError("the shardings tree does not match the state's")
    return flat


def _npz_members(path: str) -> dict:
    """{key: (shape, dtype, offset)} of an npz's members, from their
    headers (no data read); ``offset`` is where a member's C-ordered
    data starts in the file, None where it cannot be mapped (a
    compressed or Fortran-ordered member)."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        for info in zf.infolist():
            with zf.open(info) as f:
                major, minor = np.lib.format.read_magic(f)
                read = np.lib.format.read_array_header_1_0 if major == 1 \
                    else np.lib.format.read_array_header_2_0
                shape, fortran, dtype = read(f)
                header = f.tell()
            offset = None
            if info.compress_type == zipfile.ZIP_STORED and not fortran \
                    and not dtype.hasobject:
                raw.seek(info.header_offset + 26)    # local header lengths
                name_len, extra_len = struct.unpack("<HH", raw.read(4))
                offset = info.header_offset + 30 + name_len + extra_len \
                    + header
            name = info.filename
            out[name[:-4] if name.endswith(".npy") else name] = \
                (shape, dtype, offset)
    return out


def _host_array(parts, whole, keep: bool = True) -> Optional[np.ndarray]:
    """A key's parts stacked on their layer indices in a new host array
    (never a view of a CPU tensor that the next step updates in place);
    ``whole(idx, t)`` is a part's whole tensor, taken one part at a time.
    With ``keep`` False only the calls are made (a rank that does not
    write still takes part in each gather)."""
    out = None
    for idx, t in parts:
        w = whole(idx, t.detach())
        if keep:
            if out is None:
                grid = tuple(np.max([i for i, _ in parts], axis=0) + 1) \
                    if idx else ()
                out = torch.empty(grid + tuple(w.shape), dtype=w.dtype)
            out[idx].copy_(w)
        del w
    return out.numpy() if keep else None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, extra_meta: Optional[dict] = None,
             shardings=None):
        """Save ``tree`` as checkpoint ``step``; with ``shardings`` its
        tensors are this rank's blocks (every rank of the mesh calls it,
        and rank 0 writes the whole arrays)."""
        flat = _flatten(tree)
        sh = _shardings(tree, shardings)
        mesh = mesh_of(shardings)
        writer = mesh is None or mesh.rank == 0
        host = {}
        for k, parts in flat.items():
            place = dict(sh[k]) if sh is not None else None
            arr = _host_array(parts, lambda i, t: t if place is None
                              else gather_full(t, place[i]), keep=writer)
            if writer:
                host[k] = arr
        meta = {"step": int(step), "keys": sorted(flat.keys())}
        meta.update(extra_meta or {})
        self.wait()
        self._mesh = mesh
        if not writer:
            return
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
        """Wait for the write in flight; raise what it raised.  After a
        save under a mesh every rank must call it: it waits for rank 0's
        write and raises on every rank if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        mesh, self._mesh = self._mesh, None
        if mesh is not None and mesh.any(err is not None) and err is None:
            raise RuntimeError("the checkpoint write failed on rank 0")
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
    def restore(self, step: int, like_tree, shardings=None):
        """Write checkpoint ``step`` into the tensors of ``like_tree`` in
        place and return it; with ``shardings`` they are this rank's
        blocks, and each takes its slice of the whole array.  Its keys
        must be the checkpoint's and every shape must agree, or
        ``KeyError`` / ``ValueError`` is raised before anything is
        written."""
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        members = _npz_members(path)
        shapes = {k: m[0] for k, m in members.items()}
        flat = _flatten(like_tree)
        sh = _shardings(like_tree, shardings)
        if set(flat) != set(shapes):
            raise KeyError(f"checkpoint keys differ from the tree's: "
                           f"{sorted(set(flat) ^ set(shapes))[:5]}")
        slices = {}
        for key, parts in flat.items():
            n = len(parts[0][0])
            for j, (idx, t) in enumerate(parts):
                full = tuple(shapes[key][n:])
                sl = (shard_slices(full, sh[key][j][1].spec,
                                   sh[key][j][1].mesh)
                      if sh is not None else tuple(slice(None)
                                                   for _ in full))
                got = tuple(len(range(*s.indices(d)))
                            for s, d in zip(sl, full))
                if tuple(shapes[key][:n]) < tuple(i + 1 for i in idx) \
                        or got != tuple(t.shape):
                    raise ValueError(
                        f"{key}{list(idx)}: checkpoint shape {got} (of "
                        f"{shapes[key]}) != {tuple(t.shape)}")
                slices[key, idx] = sl
        with np.load(path) as z:
            for key, parts in flat.items():
                shape, dtype, offset = members[key]
                # A mapped member reads only the pages of this rank's
                # slices; an unmappable one is read whole.
                arr = z[key] if offset is None else np.memmap(
                    path, dtype=dtype, mode="r", offset=offset, shape=shape)
                for idx, t in parts:
                    t.copy_(torch.from_numpy(np.array(
                        arr[idx][slices[key, idx]])))
                del arr
        return like_tree

    def meta(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "meta.json")
        with open(path) as f:
            return json.load(f)
