"""Param specs and the parameter tree (port of src/repro/models/module.py).

Shapes and initializers are declared once as ``P`` specs, in the same
nested-dict tree as ``repro``'s (``stack`` prepends the layer axis of a
block stack).  From the spec tree come:

  * materialized params        (``init_params``) — a nested dict of
    tensors in ``repro``'s layout, drawn from an explicit
    ``torch.Generator`` (not JAX's numbers: tests carry JAX's weights
    across instead);
  * meta-device stand-ins      (``abstract_params``) — shapes without
    memory;
  * the modules' parameters    (``ParamTree``) — one ``nn.Module`` per
    dict level, a parameter per leaf, so a parameter's dotted name is its
    path in ``repro``'s tree (``blocks.3.attn.wq.w``, ``embed.table``).

``params_from_numpy`` loads a tree in ``repro``'s layout (every stacked
array split along each stacked axis of its path: ``blocks.*`` [L, ...]
per layer, the vlm's ``groups.selfs.*`` [G, k-1, ...] per group and
layer) into a model; ``init_params_into`` draws a model's random weights
straight into its parameters, one stacked leaf at a time.  The logical
sharding axes of ``repro``'s specs are kept: ``sharding.rules`` resolves
them against a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class P:
    """Spec of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | fanin
    fan_in: Optional[int] = None
    scale: float = 0.02
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict, in insertion order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def stack(specs, n: int, axis_name: str = "layers"):
    """Prepend a stacked-layer dimension to every spec in a tree."""
    return tree_map(lambda p: dataclasses.replace(
        p, shape=(n,) + p.shape, axes=(axis_name,) + p.axes), specs)


def _init_one(p: P, generator: torch.Generator, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init == "fanin":
        fan = p.fan_in or (p.shape[-2] if len(p.shape) >= 2 else p.shape[-1])
        std = 1.0 / math.sqrt(fan)
    else:
        std = p.scale
    # repro: truncated_normal(-2, 2) * std, i.e. cut at two deviations.
    t = torch.empty(p.shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(p.dtype)


def init_params(specs, generator: torch.Generator, device):
    """Materialize a spec tree into tensors on ``device``, in leaf order,
    from ``generator`` (which must live on ``device``'s type)."""
    return tree_map(lambda p: _init_one(p, generator, device), specs)


def abstract_params(specs):
    """Meta-device stand-ins: the shapes and dtypes, no memory."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), specs)


def param_count(specs) -> int:
    return int(sum(np.prod(p.shape) for p in flatten(specs).values()))


def param_bytes(specs) -> int:
    return int(sum(np.prod(p.shape) * p.dtype.itemsize
                   for p in flatten(specs).values()))


class ParamTree(nn.Module):
    """Parameters laid out as a spec tree: a submodule per dict level, an
    uninitialized parameter per ``P`` leaf, with a gradient only when
    ``requires_grad`` (a model built to train; a serving model's
    parameters have none).  ``dtype_of(name, spec)`` may store a leaf in
    another dtype than its spec's (see ``model.py``).  ``tree[k]`` and
    ``k in tree`` read it like ``repro``'s dicts, so the layer functions
    take a module or a plain dict alike."""

    def __init__(self, specs: dict, device, dtype_of=None, prefix: str = "",
                 requires_grad: bool = False):
        super().__init__()
        for k, v in specs.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, device, dtype_of, name,
                                             requires_grad))
            else:
                dtype = dtype_of(name, v) if dtype_of else v.dtype
                self.register_parameter(k, nn.Parameter(
                    torch.empty(v.shape, dtype=dtype, device=device),
                    requires_grad=requires_grad))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _per_layer(name: str, t: torch.Tensor, model: nn.Module) -> list:
    """[(parameter name, tensor)] of the leaf ``name`` of ``repro``'s tree:
    split along its leading axis at each segment of its path that is an
    ``nn.ModuleList`` of ``model`` (a stack: ``blocks`` [L, ...] gives
    ``blocks.{i}.*``; the vlm's ``groups.selfs`` [G, k-1, ...] gives
    ``groups.{g}.selfs.{j}.*``, its ``groups.cross`` [G, ...]
    ``groups.{g}.cross.*``).  A path the model lacks is passed through
    whole, for ``_check_names`` to report."""
    out = [("", t, model)]
    for seg in name.split("."):
        nxt = []
        for prefix, x, m in out:
            path = f"{prefix}.{seg}" if prefix else seg
            child = m._modules.get(seg) if m is not None else None
            if isinstance(child, nn.ModuleList):
                nxt += [(f"{path}.{i}", x[i], child[i])
                        for i in range(x.shape[0])]
            else:
                nxt.append((path, x, child))
        out = nxt
    return [(path, x) for path, x, _ in out]


def _check_names(params: dict, shapes: dict) -> None:
    missing = sorted(set(params) - set(shapes))
    extra = sorted(set(shapes) - set(params))
    if missing or extra:
        raise KeyError(f"param tree does not match the model: missing "
                       f"{missing[:8]}, extra {extra[:8]}")
    for name, p in params.items():
        if tuple(shapes[name]) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {tuple(shapes[name])} "
                             f"!= parameter shape {tuple(p.shape)}")


def params_from_numpy(model: nn.Module, tree) -> None:
    """Load ``repro``'s param tree into ``model``'s parameters.

    ``tree`` is ``repro``'s nested dict (``jax.tree.map(np.asarray,
    params)``); leaves may also be tensors (``init_params``).  The
    stacked arrays (``blocks.*``, ``dense_blocks.*``: ``[L, ...]``;
    ``groups.selfs.*``: ``[G, k-1, ...]``) are split along every stacked
    axis (``_per_layer``).  Every name must match and every shape must
    agree, or ``KeyError`` / ``ValueError`` is raised before anything is
    written; each value is cast to its parameter's dtype (f32 -> bf16
    rounds to nearest even, as ``repro``'s per-call cast in ``dense``
    does).
    """
    flat = {}
    for name, arr in flatten(tree).items():
        t = arr if isinstance(arr, torch.Tensor) else torch.tensor(
            np.asarray(arr))
        flat.update(_per_layer(name, t, model))
    params = dict(model.named_parameters())
    _check_names(params, {n: t.shape for n, t in flat.items()})
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(flat[name].to(device=p.device, dtype=p.dtype))


@torch.no_grad()
def init_params_into(model: nn.Module, generator: torch.Generator) -> None:
    """``params_from_numpy(model, init_params(model.specs, generator,
    device))`` without the whole f32 tree: each leaf of ``model.specs``
    is drawn in leaf order (the same draws, so the same weights), copied
    into its parameters (cast to their dtype) and freed before the next
    is drawn.  At Mixtral-8x7B's width the tree would hold 4 bytes a
    parameter beside the model's 2."""
    specs = flatten(model.specs)
    params = dict(model.named_parameters())
    shapes = {}
    for name, spec in specs.items():
        meta = torch.empty(spec.shape, device="meta")
        shapes.update((n, t.shape) for n, t in _per_layer(name, meta,
                                                          model))
    _check_names(params, shapes)
    device = next(iter(params.values())).device
    for name, spec in specs.items():
        t = _init_one(spec, generator, device)
        for pname, part in _per_layer(name, t, model):
            params[pname].copy_(part)
        del t
