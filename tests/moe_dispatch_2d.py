"""The one-shard MoE dispatch written on (T, D) tokens, with no shard
axis: the formula that ``repro_torch.models.moe.local_moe`` must equal
bit for bit at one shard (``moe_ffn_reference``, and ``moe_ffn`` under a
(1, 1) mesh), outputs, aux loss and gradients, on the CPU
(``tests/test_torch_moe.py``) and on the card (``tests/test_torch_cuda.py``).
Imports torch and the port only, so that it runs on the card's machine.
"""
import torch
import torch.nn.functional as F

from repro_torch.models.moe import capacity, expert_ffn


def route_2d(xt, router, cfg):
    """xt (T, D) -> ids (T, k), weights (T, k), aux (a scalar)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :cfg.top_k], ids[:, :cfg.top_k]
    w = w / w.sum(dim=-1, keepdim=True)
    f_e = F.one_hot(ids, cfg.n_experts).sum(dim=1).float().mean(dim=0)
    p_e = probs.mean(dim=0)
    return ids, w, cfg.n_experts * (f_e * p_e).sum()


def dispatch_2d(ids, cap, n_experts):
    """ids (T, k) -> flat rows (T*k,) into E*cap + 1, the spare row last."""
    flat = ids.reshape(-1)
    onehot = F.one_hot(flat, n_experts)
    pos = onehot.cumsum(dim=0).gather(1, flat[:, None])[:, 0] - 1
    keep = pos < cap
    return torch.where(keep, flat * cap + pos, n_experts * cap)


def moe_2d(cfg, p, x):
    """x (B, S, D) -> (y (B, S, D), aux): every token one shard."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    e, k, cap = cfg.n_experts, cfg.top_k, capacity(b * s, cfg)
    ids, w, a = route_2d(xt, p["router"], cfg)
    idx = dispatch_2d(ids, cap, e)
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, idx, xt.repeat_interleave(k, dim=0))
    out = expert_ffn(buf[:-1].view(e, cap, d), p["w_gate"], p["w_up"],
                     p["w_down"])
    out = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))])
    y = (out[idx].view(b * s, k, d).float() * w[:, :, None]).sum(dim=1)
    return y.to(xt.dtype).view(b, s, d), a


def grads(fn, cfg, p, x):
    """(y, aux, d(sum y * r + aux)/d(x and every weight)) of ``fn`` with
    a fixed cotangent r; leaves are fresh copies."""
    p = {n: v.detach().clone().requires_grad_(True) for n, v in p.items()}
    x = x.detach().clone().requires_grad_(True)
    y, a = fn(cfg, p, x)
    r = torch.linspace(-1, 1, y.numel(), dtype=torch.float32,
                       device=y.device).view(y.shape)
    ((y.float() * r).sum() + a).backward()
    return y.detach(), a.detach(), {"x": x.grad, **{n: v.grad
                                                    for n, v in p.items()}}
