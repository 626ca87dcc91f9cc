"""AdamW with global-norm clipping (port of src/repro/optim/adamw.py).

``repro``'s arithmetic, op for op, in f32: the clip scale
``min(1, clip / max(gnorm, 1e-9))``, the bias corrections ``1 - b**step``,
``mh / (sqrt(vh) + 1e-8)``, and the weight decay added inside the update
on every leaf (norm scales and biases included).  ``torch.optim.AdamW``
computes another formula (it decays before the update and adds eps
after ``sqrt(v) / sqrt(bc2)``), so it is not used.

Where ``repro`` maps pure functions over pytrees, the port keys its state
by the parameter's dotted name (``blocks.3.attn.wq.w``: the model's
per-layer layout) and updates the parameters and the moments in place.
The step, the learning rate, the clip scale and the grad norm stay 0-d
tensors on the parameters' device: nothing here waits for the card.

Under a mesh (``shardings``: {name: ``NamedSharding``}) the parameters,
gradients and moments are this rank's blocks, as ``repro``'s state
inherits the params' shardings; the update is elementwise, so it runs on
the blocks as they are, and only the norm is collective: each leaf's
local sum of squares is summed over exactly the axes that leaf is split
on, so a leaf every rank holds whole is counted once.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.sharding.rules import NamedSharding, PartitionSpec


class OptState(NamedTuple):
    step: torch.Tensor          # [] int32
    m: dict                     # {name: f32 tensor}
    v: dict


def init(params: dict) -> OptState:
    """Zero f32 moments for ``params`` ({name: tensor}) and step 0, on the
    parameters' device."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros, v={k: z.clone() for k, z in zeros.items()})


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum over the leaves (a dict's values, in order) of each
    leaf's f32 sum of squares; with ``shardings`` (the leaves are blocks)
    the sums of the leaves split on the same axes are added locally and
    then summed over those axes, one ``psum`` per set of axes."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree.values()))
    groups: dict = {}
    for k, g in tree.items():
        sh = shardings[k]
        axes = tuple(a for part in sh.spec if part is not None
                     for a in ((part,) if isinstance(part, str) else part))
        key = tuple(a for a in sh.mesh.axis_names if a in axes)
        sq = torch.sum(torch.square(g.float()))
        groups[key] = groups[key] + sq if key in groups else sq
    mesh = next(iter(shardings.values())).mesh
    return torch.sqrt(sum(mesh.psum(v, key) if key else v
                          for key, v in groups.items()))


def state_shardings(shardings: dict) -> OptState:
    """The ``OptState`` tree of shardings for params placed by
    ``shardings``: the moments as their parameters, the step whole."""
    mesh = next(iter(shardings.values())).mesh
    return OptState(step=NamedSharding(mesh, PartitionSpec()),
                    m=dict(shardings), v=dict(shardings))


@torch.no_grad()
def update(grads: dict, state: OptState, params: dict, run: RunConfig, lr,
           shardings=None):
    """One AdamW step, in place on ``params`` and ``state``'s moments;
    returns (params, new state, grad_norm).  ``grads``, ``state.m`` /
    ``state.v`` and ``params`` share their keys (and ``shardings``'s,
    when they are this rank's blocks)."""
    gnorm = global_norm(grads, shardings)
    # torch.div, not ``clip / t`` (torch computes that as t.reciprocal()
    # * clip, another rounding than repro's division).
    scale = torch.clamp(torch.div(torch.full_like(gnorm, run.grad_clip),
                                  torch.clamp(gnorm, min=1e-9)),
                        max=1.0) if run.grad_clip > 0 else 1.0
    step = state.step + 1
    b1, b2 = run.beta1, run.beta2
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), step.float())
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), step.float())
    for k, p in params.items():
        m, v = state.m[k], state.v[k]
        g = grads[k].float() * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        newp = pf - lr * (mh / (torch.sqrt(vh) + 1e-8)
                          + run.weight_decay * pf)
        p.copy_(newp)
    return params, OptState(step=step, m=state.m, v=state.v), gnorm


def schedule(run: RunConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning-rate schedules: cosine, WSD (MiniCPM), const; f32 [] on
    ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(run.warmup_steps, 1), max=1.0)
    if run.schedule == "const":
        return run.learning_rate * warm
    total = float(max(run.total_steps, 1))
    if run.schedule == "wsd":
        # Warmup -> Stable (80%) -> exponential Decay (last 20 %).
        decay_start = 0.8 * total
        in_decay = torch.clamp(step - decay_start, min=0.0) / (total * 0.2)
        decay = torch.exp(-5.0 * in_decay)      # ~exp decay to ~0.7% of peak
        return run.learning_rate * warm * torch.where(
            step < decay_start, 1.0, decay)
    # cosine
    frac = torch.clamp(step / total, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return run.learning_rate * warm * (0.1 + 0.9 * cos)
