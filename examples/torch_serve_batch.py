"""Batched-serving example on the PyTorch port: prefill + decode over a
request batch, with per-phase latency stats — the serving-side
end-to-end driver.  Runs on the card (``--device cpu`` for the CPU).

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--arch qwen3-4b]
      [--device cpu]
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core.engine_torch import resolve_device
from repro_torch.models import registry
from repro_torch.serve.loop import BatchServer


def run(arch: str = "qwen3-4b", batch: int = 4, prompt_len: int = 64,
        new_tokens: int = 16, cfg=None, params=None, prompts=None,
        device=None):
    """Greedy generation with ``eos_id=0`` on the arch's smoke config
    (or ``cfg``); parameters from seed 0 and prompts in [1, vocab) from
    seed 1 unless given.  Prints the example's three lines and returns
    ``generate``'s output."""
    dev = resolve_device(device, "the serve_batch example")
    cfg = cfg or configs.get_smoke(arch)
    if params is None:
        params = registry.init(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    srv = BatchServer(cfg, params, max_new_tokens=new_tokens, eos_id=0,
                      device=dev)
    if prompts is None:
        prompts = torch.randint(
            1, cfg.vocab, (batch, prompt_len),
            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    batch, prompt_len = tuple(prompts.shape)
    out = srv.generate(prompts)
    s = out["stats"]
    print(f"arch={cfg.name} batch={batch} "
          f"prompt={prompt_len} new={out['tokens'].shape[1]}")
    print(f"prefill {s.prefill_s*1e3:.1f} ms | decode "
          f"{s.per_token_ms:.2f} ms/tok | {s.throughput_tok_s:.0f} tok/s")
    print("first row:", out["tokens"][0][:12])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.arch, args.batch, args.prompt_len, args.new_tokens,
               device=args.device)


if __name__ == "__main__":
    main()
