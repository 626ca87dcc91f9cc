"""Train / serve step builders (port of src/repro/runtime/steps.py).

The port's model holds its parameters, so the loss and the serving steps
take none, and the train step updates the model's parameters in place:

  * ``loss_fn(batch) -> (loss, metrics)`` (``make_loss_fn``);
  * ``train_step(params, opt, batch) -> (params, opt, metrics)``
    (``make_train_step``): ``params`` is ``dict(model.named_parameters())``,
    updated in place with ``opt``'s moments and returned, as ``repro``'s
    pure step returns new ones; gradient accumulation over
    ``run.microbatch`` microbatches, z-loss and the MoE load-balance loss;
    ``metrics`` holds ``loss``, ``ce`` (and ``lb_loss`` / ``dropped``
    when the model reports them), ``grad_norm`` and ``lr``, 0-d tensors on
    the device (nothing waits for the card);
  * ``prefill_step(batch) -> last logits [B, V]`` and
    ``serve_step(tokens [B, 1], cache) -> (next tokens [B, 1] i32,
    cache)``, both under ``torch.inference_mode()``.

``repro``'s ``cast_params`` and ``constrain_grads`` are identities without
a mesh, so the one-device port has neither; their sharded form comes with
the distributed slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.model import Model
from repro_torch.optim import adamw


def cross_entropy(logits, labels, z_loss_coef: float):
    """Token-mean CE over f32 logits [..., V]; returns (ce + z-loss, ce).

    ``repro`` takes the gold logit as a masked sum over the one-hot of
    the label (it partitions over a sharded vocab); here it is a
    ``gather``, the same value without a second [B, S, V] f32 tensor.
    """
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(lse - gold)
    zl = z_loss_coef * torch.mean(torch.square(lse)) if z_loss_coef else 0.0
    return ce + zl, ce


def make_loss_fn(model: Model, run: RunConfig):
    cfg = model.cfg

    def loss_fn(batch):
        logits, aux = model(run, batch)
        loss, ce = cross_entropy(logits, batch["labels"], run.z_loss)
        metrics = {"ce": ce}
        if "lb_loss" in aux:
            loss = loss + cfg.router_aux_coef * aux["lb_loss"]
            metrics["lb_loss"] = aux["lb_loss"]
            metrics["dropped"] = aux["dropped"].float()
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_grad_fn(model: Model, run: RunConfig):
    """``grad_fn(params, batch) -> (grads, metrics)``: the gradients of
    the loss with respect to ``params`` ({name: parameter}), f32 sums of
    ``g / nmb`` over ``run.microbatch`` microbatches when it is above 1
    (``repro``'s scan, in its order), and the metrics (detached) averaged
    the same way.  ``make_train_step``'s gradient half."""
    loss_fn = make_loss_fn(model, run)

    def one(params, batch):
        loss, metrics = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (dict(zip(params, grads)),
                {k: m.detach() for k, m in metrics.items()})

    def grad_fn(params, batch):
        nmb = run.microbatch
        if not nmb or nmb <= 1:
            return one(params, batch)

        def split(x):
            return x.reshape((nmb, x.shape[0] // nmb) + x.shape[1:])
        mb_batch = {k: split(x) for k, x in batch.items()}
        gacc = {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for k, p in params.items()}
        dev = next(iter(params.values())).device
        names = ["ce", "loss"] + (["lb_loss", "dropped"]
                                  if model.cfg.n_experts else [])
        macc = {k: torch.zeros((), dtype=torch.float32, device=dev)
                for k in names}
        for i in range(nmb):
            grads, metrics = one(params, {k: x[i]
                                          for k, x in mb_batch.items()})
            gacc = {k: a + grads[k].float() / nmb for k, a in gacc.items()}
            macc = {k: a + metrics[k] / nmb for k, a in macc.items()}
        return gacc, macc

    return grad_fn


def make_train_step(model: Model, run: RunConfig):
    grad_fn = make_grad_fn(model, run)

    def train_step(params, opt: adamw.OptState, batch):
        grads, metrics = grad_fn(params, batch)
        lr = adamw.schedule(run, opt.step)
        params, opt, gnorm = adamw.update(grads, opt, params, run, lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt, metrics

    return train_step


def make_prefill_step(model: Model, run: RunConfig):
    """Forward-only step over a full sequence (the inference-prefill cell)."""

    @torch.inference_mode()
    def prefill_step(batch):
        logits, _ = model.forward(run, batch)
        # Next-token logits for the last position only.
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(model: Model, run: RunConfig):
    """One greedy decode step against a KV cache."""

    @torch.inference_mode()
    def serve_step(tokens, cache):
        logits, cache = model.decode_step(run, tokens, cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step
