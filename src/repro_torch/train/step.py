"""Train-step builder, PyTorch port of ``repro.train.step``: microbatched
gradient accumulation + AdamW.

The returned step is a plain function of (params, opt_state, step_idx,
batch); nothing is compiled.  It differentiates the loss with autograd
(attention's gradient is the ``flash_attention`` backward kernel on the
card) and updates parameters and moments in place
(:func:`repro_torch.optim.adamw_update`), the counterpart of the JAX
step's donated buffers.  Every family trains: dense, MoE (the loss adds
``router_aux_coef`` times the load-balancing loss, as the JAX step
does), VLM and encoder-decoder (``frontend_embeds`` in the batch), and
on the CPU the recurrent families (their kernels raise under grad on the
card, ROADMAP A8.2).  A leaf that the loss does not reach gets a zero
gradient, as ``jax.grad`` gives it, so AdamW still decays it; a loss
that reaches no leaf raises.

The JAX package's sharding constraints (``cfg.gather_weights_once``,
microbatch sharding) have no effect on one device and are left out, as
JAX skips them without a mesh; ``train_state_shardings`` and
``batch_shardings`` are mesh code (ROADMAP A12).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import registry
from repro_torch.models.common import ModelConfig, softmax_cross_entropy
from repro_torch.optim import (AdamWConfig, adamw_update, lr_schedule,
                               opt_state_specs)
from repro_torch.optim.adamw import tree_leaves, tree_map


def _loss_fn(cfg: ModelConfig, params, tokens, labels, frontend_embeds):
    """(loss, ce): a MoE adds ``router_aux_coef`` times the mean
    load-balancing loss over its layers."""
    if cfg.n_experts > 0:
        logits, aux = registry.forward(cfg, params, tokens,
                                       frontend_embeds=frontend_embeds,
                                       return_aux=True)
        ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
        return ce + cfg.router_aux_coef * aux, ce
    logits = registry.forward(cfg, params, tokens,
                              frontend_embeds=frontend_embeds)
    ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
    return ce, ce


def grads_of(cfg: ModelConfig, params, tokens, labels, frontend_embeds):
    """(gradient tree in the parameters' dtype, ce) of one microbatch.
    A leaf that the loss does not reach (a VLM's ``frontend_proj`` with
    no frontend embeddings) gets zeros, as ``jax.grad`` gives it; raises
    if the loss reaches no leaf at all."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, ce = _loss_fn(cfg, params, tokens, labels,
                                frontend_embeds)
            grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    if all(g is None for g in grads):
        raise RuntimeError(f"{cfg.name}: the loss reaches no parameter "
                           f"leaf; every leaf got no gradient")
    it = iter([torch.zeros_like(p) if g is None else g
               for g, p in zip(grads, leaves)])
    return tree_map(lambda _p: next(it), params), ce.detach()


def build_train_step(cfg: ModelConfig, *, n_microbatch: int = 1,
                     opt: AdamWConfig = AdamWConfig(),
                     lr_kwargs: Optional[dict] = None) -> Callable:
    """Returns step(params, opt_state, step_idx, batch) ->
    (params, opt_state, metrics); params and the moments are updated in
    place.

    batch = {tokens (B,S), labels (B,S)[, frontend_embeds]}.  With one
    microbatch the gradient goes to AdamW in the parameters' dtype and is
    cast to float32 leaf by leaf there (JAX's ``0 + g.astype(f32)``, bit
    for bit); with several, float32 sums are accumulated leaf by leaf and
    divided by the count, as the JAX step does."""
    lr_kwargs = lr_kwargs or {}

    def step(params, opt_state, step_idx, batch):
        tokens = batch["tokens"]
        b = tokens.shape[0]
        assert b % n_microbatch == 0, (b, n_microbatch)
        mb = b // n_microbatch
        fe_all = batch.get("frontend_embeds")
        if n_microbatch == 1:
            grads, loss = grads_of(cfg, params, tokens, batch["labels"],
                                   fe_all)
        else:
            grads = loss = None
            for i in range(n_microbatch):
                sl = slice(i * mb, (i + 1) * mb)
                g, ce = grads_of(cfg, params, tokens[sl],
                                 batch["labels"][sl],
                                 None if fe_all is None else fe_all[sl])
                if grads is None:
                    grads = tree_map(lambda x: x.float(), g)
                    loss = ce
                else:
                    tree_map(lambda a, x: a.add_(x.float()), grads, g)
                    loss = loss + ce
                del g
            grads = tree_map(lambda x: x.div_(n_microbatch), grads)
            loss = loss / n_microbatch
        lr = lr_schedule(step_idx, device=tokens.device, **lr_kwargs)
        params2, opt_state2, om = adamw_update(opt, grads, params,
                                               opt_state, lr)
        del grads
        metrics = {"loss": loss, **om}
        return params2, opt_state2, metrics

    return step


def train_state_specs(cfg: ModelConfig):
    p_specs = registry.param_specs(cfg)
    return p_specs, opt_state_specs(p_specs)

