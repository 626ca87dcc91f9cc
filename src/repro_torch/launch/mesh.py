"""Device meshes over ``torch.distributed`` (port of src/repro/launch/mesh.py
and of the mesh half of ``repro.compat``).

A ``Mesh`` names the ranks of the default process group by coordinates
on a few axes, in row-major order (jax's ``make_mesh`` device order): on
a ("data", "model") mesh of (2, 4), rank r sits at data r // 4 and model
r % 4.  It offers the two reductions the sharded geo lookup needs,
``psum`` and ``pmax`` over a tuple of axes, each one ``all_reduce`` in
the process group of this rank's slice along those axes.  ``all_reduce``
with SUM and MAX is the only collective used: NCCL and gloo both run it.

Backends: NCCL, one rank per GPU, is the deployment backend; gloo runs
the CPU tests and several ranks that share one GPU (NCCL refuses two
ranks on one device).  Where gloo refuses a CUDA tensor, ``Mesh`` copies
that buffer to the host for the reduction and back to the card, and
records it in ``route``: "direct" while tensors go to ``all_reduce`` as
they are, "host" once they are staged.  The lookup itself stays on the
card.

A mesh of size 1 needs no process group: its reductions are the
identity, the counterpart of a one-device jax mesh.  A larger mesh needs
an initialized default group of exactly its size, else it raises.

``make_production_mesh`` (the TPU pod's 16 x 16) has no counterpart yet:
it comes with the model half of the distributed port.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_test_mesh"]


class Mesh:
    """Named axes over the ranks of the default process group (see the
    module docstring).

    ``shape`` maps axis name to size, in axis order; ``coords`` maps axis
    name to this rank's coordinate.  Every rank must build the same mesh
    in the same order: construction creates the process group of every
    slice (``dist.new_group``, a call every rank makes for every group).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.route = "direct"
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.size == 1:
            self.rank = 0
        else:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"a mesh of {self.size} ranks needs an initialized "
                    f"torch.distributed process group "
                    f"(dist.init_process_group)")
            if dist.get_world_size() != self.size:
                raise ValueError(
                    f"mesh {self.shape} has {self.size} ranks, the process "
                    f"group {dist.get_world_size()}")
            self.rank = dist.get_rank()
        dims = tuple(self.shape.values())
        self.coords: Dict[str, int] = {
            a: int(c) for a, c in zip(self.axis_names,
                                      np.unravel_index(self.rank, dims))}
        if self.size > 1:
            self._make_groups(dims)

    def _make_groups(self, dims) -> None:
        """One process group per slice along every combination of the
        axes longer than 1, all created by every rank in one order."""
        ranks = np.arange(self.size).reshape(dims)
        live = [i for i, d in enumerate(dims) if d > 1]
        for r in range(1, len(live) + 1):
            for sub in itertools.combinations(live, r):
                rest = [i for i in range(len(dims)) if i not in sub]
                slices = np.transpose(ranks, rest + list(sub)).reshape(
                    -1, math.prod(dims[i] for i in sub))
                for members in slices.tolist():
                    group = dist.new_group(members)
                    if self.rank in members:
                        self._groups[tuple(self.axis_names[i]
                                           for i in sub)] = group

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in mesh "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def axis_size(self, axes) -> int:
        """Number of ranks in this rank's slice along ``axes``."""
        return math.prod(self.shape[a] for a in self._key(axes))

    def index(self, axes) -> int:
        """This rank's row-major position within its slice along
        ``axes``."""
        pos = 0
        for a in self._key(axes):
            pos = pos * self.shape[a] + self.coords[a]
        return pos

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of ``x`` over this rank's slice along ``axes``."""
        return self._all_reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise max of ``x`` over this rank's slice along
        ``axes``."""
        return self._all_reduce(x, axes, dist.ReduceOp.MAX)

    def _all_reduce(self, x, axes, op) -> torch.Tensor:
        key = self._key(axes)
        if not key:
            return x
        group = self._groups[key]
        out = x.clone()
        if not out.is_cuda or self.route == "direct":
            try:
                dist.all_reduce(out, op=op, group=group)
                return out
            except RuntimeError as e:
                # A refused device, not a failed exchange: every rank
                # takes this branch at the same call, since gloo checks
                # the device before it communicates.
                if (not out.is_cuda or isinstance(e, dist.DistBackendError)
                        or dist.get_backend(group) != "gloo"):
                    raise
                self.route = "host"
        host = out.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(out.device)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """The mesh of ``shape`` over ``axes`` on the default process group."""
    return Mesh(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """Small mesh for multi-rank tests (gloo CPU ranks)."""
    return make_mesh(shape, axes)
