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

The model half (``sharding.rules``, ``runtime.steps`` with a mesh) adds
two collectives, each tiled along one dimension in the row-major order
of the named axes (jax's ``all_gather(..., tiled=True)`` and
``psum_scatter``): ``all_gather`` and ``psum_scatter``.  Each tries the
backend's own collective first; where gloo refuses a CUDA tensor it
goes through ``psum`` (a zero buffer holding this rank's block for a
gather, a slice of the sum for a scatter), and ``routes`` says so:
"direct" or "psum" per collective, beside ``route`` ("direct" or
"host") for ``all_reduce`` itself.  Five ``torch.autograd.Function``s
carry them through a backward, Megatron's pairs:

  * ``gather_fwd``: all-gather forward; reduce-scatter backward (the
    axes the batch is split on: every rank's gradient is a share), or
    this rank's slice of the gradient (axes every rank computes alike);
  * ``scatter_fwd``: reduce-scatter forward, all-gather backward (a sum
    of partial results of which each rank keeps its block: the
    sequence-parallel residual's row-parallel products), the partner of
    ``gather_fwd(..., reduce=True)``;
  * ``block_fwd``: this rank's block forward, all-gather backward (a
    value every rank holds alike, of which each rank goes on with its
    block);
  * ``psum_fwd``: psum forward, identity backward (a sum of partial
    results whose consumers are the same on every rank);
  * ``psum_bwd``: identity forward, psum backward (a value every rank
    holds alike that enters rank-specific work).

``Mesh.with_batch(axes)`` is a view of the mesh that also names the
axes the batch rows are split on (``batch_axes``; the steps make it):
the model code under a mesh runs on this rank's rows and reads it.
``AbstractMesh`` (names and sizes, no process group) stands for meshes
no process runs, such as ``make_production_mesh``'s TPU pod shapes.
"""
from __future__ import annotations

import copy
import itertools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AbstractMesh", "Mesh", "block_fwd", "gather_fwd", "make_mesh",
           "make_production_mesh", "make_test_mesh", "psum_bwd", "psum_fwd",
           "scatter_fwd"]


class AbstractMesh:
    """Axis names and sizes only (jax's ``AbstractMesh``): enough for the
    sharding rules, which read ``axis_names`` and ``shape``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


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
        self.batch_axes: Tuple[str, ...] = ()
        # Shared with every view (``with_batch``).
        self.routes: Dict[str, str] = {"all_reduce": "direct",
                                       "all_gather": "direct",
                                       "reduce_scatter": "direct"}
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

    @property
    def route(self) -> str:
        """``all_reduce``'s route: "direct", or "host" once gloo refused a
        CUDA buffer and the reductions are staged through the host."""
        return self.routes["all_reduce"]

    def with_batch(self, axes) -> "Mesh":
        """A view of this mesh (the same ranks, groups and routes) whose
        ``batch_axes`` are ``axes``: the axes this rank's batch rows are
        split on."""
        view = copy.copy(self)
        view.batch_axes = tuple(axes)
        return view

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

    def _direct(self, name: str, x: torch.Tensor, group, call) -> bool:
        """Run ``call()`` (the backend's collective on ``x``) unless
        ``name``'s route left "direct"; False where gloo refused the CUDA
        tensor (the route is then "host" for ``all_reduce``, "psum" for
        the others)."""
        if x.is_cuda and self.routes[name] != "direct":
            return False
        try:
            call()
            return True
        except RuntimeError as e:
            # A refused device, not a failed exchange: every rank takes
            # this branch at the same call, since gloo checks the device
            # before it communicates.
            if (not x.is_cuda or isinstance(e, dist.DistBackendError)
                    or dist.get_backend(group) != "gloo"):
                raise
            self.routes[name] = "host" if name == "all_reduce" else "psum"
            return False

    def _all_reduce(self, x, axes, op) -> torch.Tensor:
        key = self._key(axes)
        if not key:
            return x
        group = self._groups[key]
        out = x.clone()
        if self._direct("all_reduce", out, group,
                        lambda: dist.all_reduce(out, op=op, group=group)):
            return out
        host = out.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(out.device)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """The blocks of ``x`` of every rank in this rank's slice along
        ``axes``, concatenated along ``dim`` in the slice's row-major
        order (``axes`` in mesh order), contiguous: a product on the
        permuted view runs another cuBLAS kernel than one process's on
        the whole tensor, and rounds differently.  No gradient:
        ``gather_fwd`` is the differentiable form."""
        key = self._key(axes)
        if not key:
            return x
        n, i = self.axis_size(key), self.index(key)
        group = self._groups[key]
        xt = x.detach().movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
        fn = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        if not self._direct("all_gather", xt, group,
                            lambda: fn(out, xt, group=group)):
            buf = torch.zeros_like(out)
            buf[i * xt.shape[0]:(i + 1) * xt.shape[0]] = xt
            out = self.psum(buf, key)
        return out.movedim(0, dim).contiguous()

    def psum_scatter(self, x: torch.Tensor, axes, dim: int = 0
                     ) -> torch.Tensor:
        """This rank's block (along ``dim``, in the slice's row-major
        order) of the sum of ``x`` over its slice along ``axes``,
        contiguous."""
        key = self._key(axes)
        if not key:
            return x
        n, i = self.axis_size(key), self.index(key)
        group = self._groups[key]
        xt = x.detach().movedim(dim, 0).contiguous()
        if xt.shape[0] % n:
            raise ValueError(f"psum_scatter: dimension {dim} of "
                             f"{tuple(x.shape)} over {n} ranks")
        size = xt.shape[0] // n
        out = xt.new_empty((size,) + xt.shape[1:])
        fn = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        if not self._direct("reduce_scatter", xt, group,
                            lambda: fn(out, xt, group=group)):
            out = self.psum(xt, key)[i * size:(i + 1) * size]
        return out.movedim(0, dim).contiguous()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (every rank must call it:
        it is also a barrier).  The flag travels on the device NCCL
        reduces on, the CPU for gloo."""
        if self.size == 1:
            return bool(flag)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
        return bool(self.pmax(t, self.axis_names).item())


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """The mesh of ``shape`` over ``axes`` on the default process group."""
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The TPU pod's mesh shape: 16 x 16 ("data", "model"); two pods for
    the multi-pod mesh, (2, 16, 16) ("pod", "data", "model").  Abstract:
    no process group of that size is made (the sharding rules read it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """Small mesh for multi-rank tests (gloo CPU ranks)."""
    return make_mesh(shape, axes)


# ------------------------------------------------ collectives under autograd
class _GatherFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, key, dim, reduce):
        ctx.mesh, ctx.key, ctx.dim, ctx.reduce = mesh, key, dim, reduce
        ctx.size = x.shape[dim]
        return mesh.all_gather(x, key, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, key, dim = ctx.mesh, ctx.key, ctx.dim
        if ctx.reduce:
            gx = mesh.psum_scatter(g, key, dim)
        else:
            gx = g.narrow(dim, mesh.index(key) * ctx.size, ctx.size)
        return gx, None, None, None, None


class _ScatterFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, key, dim):
        ctx.mesh, ctx.key, ctx.dim = mesh, key, dim
        return mesh.psum_scatter(x, key, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.key, ctx.dim), None, None, None


class _BlockFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, key, dim):
        ctx.mesh, ctx.key, ctx.dim = mesh, key, dim
        n = x.shape[dim] // mesh.axis_size(key)
        return x.narrow(dim, mesh.index(key) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.key, ctx.dim), None, None, None


class _PsumFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, key):
        return mesh.psum(x, key)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, key):
        ctx.mesh, ctx.key = mesh, key
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.key), None, None


def gather_fwd(x: torch.Tensor, mesh: Mesh, axes, dim: int,
               reduce: bool = True) -> torch.Tensor:
    """``mesh.all_gather(x, axes, dim)`` whose backward reduce-scatters
    the gradient over ``axes`` (``reduce``: each rank holds a share of
    it) or takes this rank's slice of it (each rank holds all of it)."""
    key = mesh._key(axes)
    return _GatherFwd.apply(x, mesh, key, dim, reduce) if key else x


def scatter_fwd(x: torch.Tensor, mesh: Mesh, axes, dim: int
                ) -> torch.Tensor:
    """``mesh.psum_scatter(x, axes, dim)`` whose backward all-gathers the
    gradient: each rank holds its block's, and every rank's partial
    reads the whole."""
    key = mesh._key(axes)
    return _ScatterFwd.apply(x, mesh, key, dim) if key else x


def block_fwd(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (in the
    slice's row-major order, as ``all_gather`` concatenates), for an x
    every rank holds alike: the backward all-gathers the gradient, each
    rank's covering its block."""
    key = mesh._key(axes)
    if not key:
        return x
    if x.shape[dim] % mesh.axis_size(key):
        raise ValueError(f"block_fwd: dimension {dim} of {tuple(x.shape)} "
                         f"over {mesh.axis_size(key)} ranks")
    return _BlockFwd.apply(x, mesh, key, dim)


def psum_fwd(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``mesh.psum(x, axes)`` whose backward passes the gradient on as it
    is."""
    key = mesh._key(axes)
    return _PsumFwd.apply(x, mesh, key) if key else x


def psum_bwd(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``x`` itself, whose backward sums the gradient over ``axes``."""
    key = mesh._key(axes)
    return _PsumBwd.apply(x, mesh, key) if key else x
