"""End-to-end driver on the PyTorch port: train a ~100M-param
qwen3-family model with the full runtime (synthetic data, AdamW, async
checkpoints, failure injection + elastic restart, straggler monitor).

Default is a quick preset; ``--full`` trains the real ~100M config.
Runs on the card (``--device cpu`` for the CPU).

Run:  PYTHONPATH=src python examples/torch_train_100m.py [--full]
      [--steps N] [--fail-at K] [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig


def model_100m() -> ModelConfig:
    return dataclasses.replace(
        configs.get("qwen3-4b"), name="qwen3-100m",
        n_layers=16, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
        d_ff=2048, vocab=32_000)


def model_quick() -> ModelConfig:
    return dataclasses.replace(
        configs.get("qwen3-4b"), name="qwen3-20m",
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=1024, vocab=8_192, remat=False)


def trainer_config(full: bool, steps: int, ckpt_dir: str) -> TrainerConfig:
    return TrainerConfig(
        n_steps=steps,
        seq_len=256 if full else 128,
        global_batch=8 if full else 4,
        checkpoint_every=25,
        checkpoint_dir=ckpt_dir,
        log_every=10,
        peak_lr=6e-4, warmup=20)


def train(cfg: ModelConfig, tcfg: TrainerConfig, fail_at=None,
          device=None, params=None):
    """``Trainer.run`` with a simulated host failure at step ``fail_at``;
    ``params`` (a tree like ``registry.init``'s) replaces the drawn
    initial parameters, also on a restart without a checkpoint."""
    inj = FailureInjector(fail_at_steps={fail_at} if fail_at else set())
    tr = Trainer(cfg, tcfg, injector=inj, device=device)
    if params is not None:
        draw = tr.init_state

        def init_state():
            p, opt = draw()
            with torch.no_grad():
                tree_map(lambda d, s: d.copy_(torch.as_tensor(s)), p, params)
            return p, opt
        tr.init_state = init_state
    return tr.run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated host failure at this step")
    # not the JAX example's directory: neither restores the other's files
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train100m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = model_100m() if args.full else model_quick()
    n_params = cfg.n_params()
    steps = args.steps or (300 if args.full else 60)
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, {steps} steps")

    out = train(cfg, trainer_config(args.full, steps, args.ckpt_dir),
                args.fail_at, args.device)
    losses = [h["loss"] for h in out["history"]]
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"restarts={out['restarts']}, "
          f"stragglers={len(out['stragglers'])}")
    assert losses[-1] < losses[0], "loss must decrease"
    return out


if __name__ == "__main__":
    main()
