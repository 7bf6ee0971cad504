"""Train-step builder, PyTorch port of ``repro.train.step``: microbatched
gradient accumulation + AdamW.

The returned step is a plain function of (params, opt_state, step_idx,
batch); nothing is compiled.  It differentiates the loss with autograd
(on the card the gradients of attention and of the recurrences are the
``flash_attention``, ``rglru_scan`` and ``mlstm_chunkwise`` backward
kernels) and updates parameters and moments in place
(:func:`repro_torch.optim.adamw_update`), the counterpart of the JAX
step's donated buffers.  Every family trains, on the card and on the
CPU: dense, MoE (the loss adds ``router_aux_coef`` times the
load-balancing loss, as the JAX step does), VLM and encoder-decoder
(``frontend_embeds`` in the batch), and the recurrent families
(recurrentgemma and xlstm).  A leaf that the loss does not reach gets a zero
gradient, as ``jax.grad`` gives it, so AdamW still decays it; a loss
that reaches no leaf raises.

Under an active mesh (logical on the port's one card) the JAX step adds
two ``with_sharding_constraint``s, which change no value: the weights
gathered once over the FSDP axis (``cfg.gather_weights_once``) and each
microbatch sharded over every data axis.  The port computes the first's
specs (:func:`gathered_shardings`, so a parameter tree that does not
fit the family's axes raises, as in JAX); the second is a layout of a
fixed spec, which raises nothing, and is left out.
``train_state_shardings`` and ``batch_shardings`` give the specs of the
train state and the batch on the mesh, as the JAX package's do (what
each shard would hold; the tensors stay whole on the card).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models import registry
from repro_torch.models.common import ModelConfig, softmax_cross_entropy
from repro_torch.optim import (AdamWConfig, adamw_update, lr_schedule,
                               opt_state_specs)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd


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
        mesh = pctx.get_mesh()
        if cfg.gather_weights_once and mesh is not None:
            gathered_shardings(cfg, mesh, params)
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


def gathered_shardings(cfg: ModelConfig, mesh, params):
    """The TP-only layout that ``cfg.gather_weights_once`` constrains the
    weights to under ``mesh`` (the FSDP dims ``embed`` and
    ``expert_mlp`` replicated), over the parameter tree ``params``.
    Raises ``ValueError`` where the tree does not fit the family's
    logical axes, as JAX's tree map does; no value depends on it."""
    rules = dict(shd.DEFAULT_RULES, embed=None, expert_mlp=None)
    return shd.shardings_from_axes(registry.logical_axes(cfg), mesh, rules,
                                   params)


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------


def train_state_shardings(cfg: ModelConfig, mesh,
                          rules: Optional[dict] = None):
    """(param_shardings, opt_shardings): trees of
    :class:`~repro_torch.parallel.sharding.Sharding` with the parameter
    tree's keys (and the optimizer state's: ``m``, ``v``, ``count``)."""
    axes = registry.logical_axes(cfg)
    p_specs = registry.param_specs(cfg)
    p_sh = shd.shardings_from_axes(axes, mesh, rules, p_specs)
    o_sh = {
        "m": p_sh,
        "v": p_sh,
        "count": shd.Sharding(mesh, ()),
    }
    return p_sh, o_sh


def batch_shardings(cfg: ModelConfig, mesh, specs: Dict) -> Dict:
    """Each batch leaf's sharding: batch over the data axes, the rest
    replicated; ``specs`` maps names to shapes or to anything with
    ``.shape``."""
    return {k: shd.batch_sharding(mesh, ndim=len(getattr(s, "shape", s)))
            for k, s in specs.items()}


def train_state_specs(cfg: ModelConfig):
    p_specs = registry.param_specs(cfg)
    return p_specs, opt_state_specs(p_specs)

