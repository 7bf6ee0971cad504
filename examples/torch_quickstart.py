"""Quickstart on the PyTorch port: the three layers of LiveStack in one
minute.

1. run a reduced architecture from the zoo (forward + loss),
2. serve it (prefill + decode),
3. simulate a 2-component live workload under virtual time.

Parts 1 and 2 run on the card (``--device cpu`` for the CPU); part 3 is
pure Python.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core import (Endpoint, Hub, LinkSpec, LiveCall, Recv,
                              Scheduler, Scope, Send, State, US, VTask)
from repro_torch.core.engine_torch import resolve_device
from repro_torch.models import registry
from repro_torch.models.common import softmax_cross_entropy


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def part1_model(cfg=None, params=None, tokens=None, device=None):
    """Forward and loss of the qwen3-4b smoke config; returns (logits,
    loss).  ``cfg``, ``params`` and ``tokens`` default to the smoke
    config, ``registry.init`` from seed 0 and tokens from seed 1."""
    print("=== 1. model zoo ===")
    dev = resolve_device(device, "the quickstart's model")
    cfg = cfg or configs.get_smoke("qwen3-4b")
    if params is None:
        params = registry.init(cfg, _generator(dev, 0), device=dev)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (2, 32),
                               generator=_generator(dev, 1), device=dev)
    tokens = torch.as_tensor(tokens).to(dev)
    with torch.no_grad():
        logits = registry.forward(cfg, params, tokens)
        loss = softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
    print(f"  {cfg.name}: logits {tuple(logits.shape)}, "
          f"loss {float(loss):.3f}")
    full = configs.get("qwen3-4b")
    print(f"  full config: {full.n_layers}L d={full.d_model} "
          f"params={full.n_params()/1e9:.2f}B")
    return logits, loss


def part2_serving(cfg=None, params=None, prompts=None, device=None):
    """``BatchServer`` on the smoke config, 8 new tokens for 2 prompts of
    16 (seed 2); returns ``generate``'s output."""
    print("=== 2. serving ===")
    from repro_torch.serve.loop import BatchServer

    dev = resolve_device(device, "the quickstart's server")
    cfg = cfg or configs.get_smoke("qwen3-4b")
    if params is None:
        params = registry.init(cfg, _generator(dev, 0), device=dev)
    srv = BatchServer(cfg, params, max_new_tokens=8, device=dev)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab, (2, 16),
                                generator=_generator(dev, 2), device=dev)
    out = srv.generate(prompts)
    s = out["stats"]
    print(f"  generated {out['tokens'].shape} tokens, "
          f"{s.per_token_ms:.1f} ms/tok, {s.throughput_tok_s:.0f} tok/s")
    return out


def part3_livestack():
    """A client and a server exchanging 20 RPCs over one hub, the server
    doing real work per request (its vtime from the host clock)."""
    print("=== 3. live simulation (the paper) ===")
    hub = Hub("net", LinkSpec(bandwidth_bps=10e9 * 8, latency_ns=50_000))
    sched = Scheduler(n_cpus=2)
    cl = hub.attach(Endpoint("client"))
    sv = hub.attach(Endpoint("server"))

    def real_work():                     # LIVE code, natively executed
        return sum(i * i for i in range(20_000))

    def client():
        for i in range(20):
            yield Send(cl, "server", 16_384)
            yield Recv(cl)

    def server():
        for _ in range(20):
            yield Recv(sv)
            yield LiveCall(real_work)    # clock-derived vtime
            yield Send(sv, "client", 256)

    c = sched.spawn(VTask("client", client(), kind="live"))
    s = sched.spawn(VTask("server", server(), kind="live"))
    scope = Scope("rpc", skew_bound_ns=200 * US)
    c.join(scope)
    s.join(scope)
    t0 = time.perf_counter()
    sched.run()
    wall = time.perf_counter() - t0
    print(f"  simulated {c.vtime/1e6:.2f} ms of cluster time in "
          f"{wall*1e3:.1f} ms wall "
          f"({sched.stats.dispatches} dispatches, "
          f"{sched.stats.skew_stalls} skew stalls)")
    done = c.state is State.DONE and s.state is State.DONE
    return {"status": "ok" if done else "stuck",
            "round_trips": hub.stats["messages"] // 2}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of parts 1 and 2 (default: cuda)")
    args = ap.parse_args(argv)
    return {"model": part1_model(device=args.device),
            "serving": part2_serving(device=args.device),
            "live": part3_livestack()}


if __name__ == "__main__":
    main()
