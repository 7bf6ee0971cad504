"""Fault-tolerant training runtime, PyTorch port of
``repro.runtime.trainer``.

Wires together: model zoo + train step + synthetic data + AdamW
(+ optional int8 gradient compression with error feedback) + checkpoint
manager (async, atomic) + failure injection (restart from the last
commit, elastic re-mesh) + straggler monitor.

The trainer runs on ``device`` (``None`` means CUDA and raises without
it).  The step is a plain function rebuilt by ``_build``; nothing is
compiled, and parameters and moments are updated in place.  A mesh is
logical on the port's one card (``repro_torch.launch.mesh``): it is set
as the active mesh while the trainer runs and places nothing.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMData
from repro_torch.launch import shapes as shp
from repro_torch.models import registry
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.compress import compress_grads, ef_init
from repro_torch.parallel import ctx as pctx
from repro_torch.runtime.failures import (FailureInjector, SimulatedHostFailure,
                                          StragglerMonitor)
from repro_torch.train.step import build_train_step


def _default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    n_microbatch: int = 1
    checkpoint_every: int = 20
    checkpoint_dir: str = dataclasses.field(
        default_factory=_default_checkpoint_dir)
    checkpoint_async: bool = True
    keep_checkpoints: int = 3
    compress_grads: bool = False
    log_every: int = 10
    peak_lr: float = 3e-4
    warmup: int = 20
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, mesh=None,
                 injector: Optional[FailureInjector] = None,
                 log_fn: Callable[[str], None] = print, device=None):
        from repro_torch.core.engine_torch import resolve_device
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device, "the trainer")
        self.injector = injector or FailureInjector()
        self.monitor = StragglerMonitor()
        self.log = log_fn
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                      keep=tcfg.keep_checkpoints)
        self.data = SyntheticLMData(
            vocab=cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed,
            frontend_dim=cfg.frontend_dim,
            frontend_tokens=shp.frontend_tokens(cfg, tcfg.seq_len),
            device=self.device)
        self.history: list = []
        self.restarts = 0
        self._build()

    # -- build ----------------------------------------------------------------
    def _build(self) -> None:
        tcfg = self.tcfg
        step_fn = build_train_step(
            self.cfg, n_microbatch=tcfg.n_microbatch,
            lr_kwargs=dict(peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                           total=tcfg.n_steps))
        if tcfg.compress_grads:
            step_fn = self._with_compression(step_fn)
        self.step = step_fn
        # one device: nothing to shard, whatever the mesh
        self.p_sh = self.o_sh = None

    def _with_compression(self, step_fn):
        cfg = self.cfg
        tcfg = self.tcfg
        from repro_torch.optim import adamw_update, lr_schedule
        from repro_torch.train.step import grads_of

        def step(params, opt_state, step_idx, batch):
            ef = opt_state["ef"]
            inner = {k: v for k, v in opt_state.items() if k != "ef"}
            grads, ce = grads_of(cfg, params, batch["tokens"],
                                 batch["labels"],
                                 batch.get("frontend_embeds"))
            grads, ef = compress_grads(grads, ef)
            lr = lr_schedule(step_idx, peak_lr=tcfg.peak_lr,
                             warmup=tcfg.warmup, total=tcfg.n_steps,
                             device=self.device)
            params, inner, om = adamw_update(AdamWConfig(), grads, params,
                                             inner, lr)
            return params, dict(inner, ef=ef), {"loss": ce, **om}

        return step

    # -- state ----------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = registry.init(self.cfg, gen, device=self.device)
        opt = adamw_init(params)
        if self.tcfg.compress_grads:
            opt = dict(opt, ef=ef_init(params))
        return params, opt

    # -- loop -----------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        params, opt = self.init_state()
        start = 0
        ctx = (pctx.use_mesh(self.mesh) if self.mesh is not None
               else _null_ctx())
        with ctx:
            step = start
            while step < self.tcfg.n_steps:
                try:
                    params, opt, step = self._run_span(params, opt, step)
                except SimulatedHostFailure as e:
                    self.log(f"[trainer] {e}; elastic restart")
                    self.restarts += 1
                    params = opt = None
                    params, opt, step = self._recover()
        self.ckpt.wait()
        return {"history": self.history, "restarts": self.restarts,
                "stragglers": self.monitor.stragglers,
                "final_step": step}

    def _run_span(self, params, opt, start):
        for step in range(start, self.tcfg.n_steps):
            self.injector.check(step)
            batch = self.data.batch(step)
            t0 = time.perf_counter()
            params, opt, metrics = self.step(params, opt, step, batch)
            loss = float(metrics["loss"])          # the step's one host read
            wall = time.perf_counter() - t0
            if self.monitor.record(step, wall):
                self.log(f"[trainer] straggler step {step}: {wall:.3f}s")
            self.history.append({"step": step, "loss": loss,
                                 "wall_s": wall})
            if step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {step} loss {loss:.4f} "
                         f"({wall*1e3:.0f} ms)")
            if (step + 1) % self.tcfg.checkpoint_every == 0:
                self.ckpt.save({"params": params, "opt": opt}, step + 1,
                               blocking=not self.tcfg.checkpoint_async)
        return params, opt, self.tcfg.n_steps

    def _recover(self):
        """Elastic restart: rebuild state on the (possibly new) mesh and
        resume from the last committed checkpoint."""
        params0, opt0 = self.init_state()          # fresh buffers
        like = {"params": params0, "opt": opt0}
        try:
            state, step, _ = self.ckpt.restore_latest(like)
        except FileNotFoundError:
            self.log("[trainer] no checkpoint yet; restart from scratch")
            return params0, opt0, 0
        return state["params"], state["opt"], step


class _null_ctx:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False
