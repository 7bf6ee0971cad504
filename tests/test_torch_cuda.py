"""The port's kernels and models on the card, against their plain
versions, and the training path's gradient (the flash backward kernel,
three train steps against the CPU, the recurrent kernels' raise under
grad).  Marked ``cuda``: without a CUDA card every test skips
(decided in the fixture, not at import).  This file imports neither JAX
nor the JAX package, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-4 relative to max(1, largest |plain value|) in float32 (the
same float32 arithmetic with sums in another order), 2e-2 for bfloat16
outputs (one rounding to bfloat16); chip_smoke.py holds the same kernels
at the serving shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype=torch.float32):
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    assert err <= TOL[dtype] * scale, (err, scale)


def _rglru_inputs(dev, b, s, w, with_h0):
    g = torch.Generator(device=dev).manual_seed(0)
    log_a = -torch.rand(b, s, w, generator=g, device=dev) * 0.3
    bv = torch.randn(b, s, w, generator=g, device=dev)
    h0 = torch.randn(b, w, generator=g, device=dev) if with_h0 else None
    return log_a, bv, h0


#: small shapes, odd W with S not a multiple of the chunk, and a long
#: chain of chunks (64 at the kernel's T_c of 256)
@pytest.mark.parametrize("b,s,w,with_h0", [(2, 300, 32, True),
                                           (3, 64, 128, False),
                                           (1, 7, 4100, True),
                                           (2, 515, 4099, True),
                                           (1, 16384, 1024, False)])
def test_rglru_kernel_vs_plain(dev, b, s, w, with_h0):
    from repro_torch.kernels.ref import rglru_plain
    from repro_torch.kernels.rglru_scan import rglru_scan
    log_a, bv, h0 = _rglru_inputs(dev, b, s, w, with_h0)
    before = rglru_scan.launches
    got = rglru_scan(log_a, bv, h0)
    assert rglru_scan.launches == before + 1
    _close(got, rglru_plain(log_a, bv, h0))


def test_rglru_kernel_two_calls_bit_equal(dev):
    """The carry is chained in one fixed order: recurrentgemma's prefill
    shape gives the same bits on every call."""
    from repro_torch.kernels.rglru_scan import rglru_scan
    log_a, bv, h0 = _rglru_inputs(dev, 4, 3072, 4096, True)
    assert torch.equal(rglru_scan(log_a, bv, h0), rglru_scan(log_a, bv, h0))


#: both dtypes at small shapes; in bfloat16 also xlstm_1_3b's head dim
#: (the tensor-core kernel) and one above its limit (the first design)
MLSTM_SHAPES = [(2, 200, 64, True), (3, 128, 32, False), (1, 70, 100, True)]


@pytest.mark.parametrize(
    "dtype,bh,s,hd,carry",
    [(dt, *shape) for dt in (torch.float32, torch.bfloat16)
     for shape in MLSTM_SHAPES]
    + [(torch.bfloat16, 2, 128, 1024, True),
       (torch.bfloat16, 1, 64, 2880, True)])
def test_mlstm_kernel_vs_plain(dev, dtype, bh, s, hd, carry):
    from repro_torch.kernels.mlstm_kernel import (mlstm_chunkwise,
                                                  mlstm_flat_plain,
                                                  uses_sm90)
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(bh, s, hd, generator=g, device=dev).mul(0.3)
               .to(dtype) for _ in range(3))
    ig = torch.randn(bh, s, generator=g, device=dev)
    fg = torch.randn(bh, s, generator=g, device=dev) + 2.0
    c0 = torch.randn(bh, hd, hd, generator=g, device=dev) * 0.1 \
        if carry else None
    n0 = torch.randn(bh, hd, generator=g, device=dev) * 0.1 if carry else None
    before = mlstm_chunkwise.launches
    h, (c, n) = mlstm_chunkwise(q, k, v, ig, fg, c0, n0)
    assert mlstm_chunkwise.launches == before + 1
    assert mlstm_chunkwise.source == ("mlstm_kernel_sm90.cu"
                                      if uses_sm90(dtype, hd)
                                      else "mlstm_kernel.cu")
    hw, (cw, nw) = mlstm_flat_plain(q, k, v, ig, fg, c0, n0)
    _close(h, hw, dtype)
    _close(c, cw)
    _close(n, nw)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_1_3b"])
def test_recurrent_models_card_vs_cpu(dev, arch):
    """Smoke config in float32: prefill past the window, then decode, on
    the card (kernels) and on the CPU (plain versions)."""
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    params = registry.init(cfg, torch.Generator(device=dev).manual_seed(2),
                           device=dev)
    cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
               else v.cpu()) for k, v in params.items()}
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 100)).astype(np.int32))
    lg, cg = registry.prefill(cfg, params, tokens.to(dev))
    lc, cc = registry.prefill(cfg, cpu, tokens)
    _close(lg.cpu(), lc)
    for _ in range(3):
        tok = lc.argmax(-1).to(torch.int32)
        lg, cg = registry.decode_step(cfg, params, tok.to(dev), cg)
        lc, cc = registry.decode_step(cfg, cpu, tok, cc)
        _close(lg.cpu(), lc)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "pixtral_12b",
                                  "seamless_m4t_medium"])
def test_serving_families_card_vs_cpu(dev, arch):
    """Smoke config in float32 with its frontend embeddings: prefill, then
    decode, on the card (kernels) and on the CPU (plain versions); the
    MoE's routing is the same on both sides, so is its dropped-slot mask
    in the first layer's prefill."""
    from repro_torch import configs
    from repro_torch.models import moe, registry
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    params = registry.init(cfg, torch.Generator(device=dev).manual_seed(2),
                           device=dev)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}
    cpu = to_cpu(params)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100)).astype(
        np.int32))
    fe = None
    if cfg.frontend:
        nf = cfg.n_frontend_tokens if cfg.frontend == "patch" else 64
        fe = torch.from_numpy(rng.standard_normal(
            (2, nf, cfg.frontend_dim)).astype(np.float32))
    keeps = []
    inner = moe.dispatch_indices

    def record(ids, cap, n):
        idx, keep = inner(ids, cap, n)
        keeps.append(keep.cpu())
        return idx, keep
    moe.dispatch_indices = record
    try:
        lg, cg = registry.prefill(cfg, params, tokens.to(dev),
                                  frontend_embeds=None if fe is None
                                  else fe.to(dev))
        lc, cc = registry.prefill(cfg, cpu, tokens, frontend_embeds=fe)
    finally:
        moe.dispatch_indices = inner
    _close(lg.cpu(), lc)
    if cfg.n_experts:
        half = len(keeps) // 2
        assert torch.equal(keeps[0], keeps[half])
    for _ in range(3):
        tok = lc.argmax(-1).to(torch.int32)
        lg, cg = registry.decode_step(cfg, params, tok.to(dev), cg)
        lc, cc = registry.decode_step(cfg, cpu, tok, cc)
        _close(lg.cpu(), lc)


# (B, H, Hkv, Sq, Sk, hd, causal, window): head dims that are not multiples
# of 16 (the bf16 kernel pads them to 64), one query row, fewer queries
# than keys under the causal mask, a window narrower than a key tile,
# cross attention, MQA at hd 256 with a window; seamless_m4t_medium's
# encoder (non-causal), its cross-attention (1,024 queries against 256
# frames) and its decoder's self-attention (MHA, hd 64)
FLASH_EDGE = [(2, 4, 2, 100, 100, 8, True, 0),
              (1, 4, 1, 130, 130, 24, True, 0),
              (1, 4, 2, 70, 70, 40, False, 0),
              (2, 4, 2, 1, 1, 64, True, 0),
              (2, 4, 2, 1, 77, 64, False, 0),
              (1, 4, 2, 50, 300, 128, True, 0),
              (1, 4, 2, 200, 200, 64, True, 5),
              (1, 2, 2, 64, 192, 32, False, 0),
              (1, 4, 1, 300, 300, 256, True, 100),
              (4, 16, 16, 256, 256, 64, False, 0),
              (4, 16, 16, 1024, 256, 64, False, 0),
              (4, 16, 16, 1024, 1024, 64, True, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,window", FLASH_EDGE)
def test_flash_kernel_vs_plain(dev, dtype, b, h, hkv, sq, sk, hd, causal,
                               window):
    from repro_torch.kernels.flash_attention import flash_attention_flat
    from repro_torch.kernels.ref import attention_flat_plain
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b * h, sq, hd, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b * hkv, sk, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = flash_attention_flat.launches
    got = flash_attention_flat(q, k, v, causal=causal, window=window)
    assert flash_attention_flat.launches == before + 1
    _close(got, attention_flat_plain(q, k, v, causal=causal, window=window),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fused", "heads_first"])
def test_flash_strided_views_vs_plain(dev, dtype, kind):
    """``ops.flash_attention`` on non-contiguous (B, S, H, hd) views (bf16
    reads them in place) against the plain version of contiguous copies."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_flat_plain
    g = torch.Generator(device=dev).manual_seed(4)
    b, s, h, hkv, hd = 2, 150, 8, 2, 64
    if kind == "fused":
        x = torch.randn(b, s, h + 2 * hkv, hd, generator=g, device=dev)
        q, k, v = (x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:])
    else:
        x = torch.randn(b, h + 2 * hkv, s, hd, generator=g, device=dev)
        q, k, v = (t.transpose(1, 2) for t in (x[:, :h], x[:, h:h + hkv],
                                               x[:, h + hkv:]))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=True, window=40)
    want = attention_flat_plain(
        *(t.transpose(1, 2).reshape(-1, s, hd).contiguous()
          for t in (q, k, v)), causal=True, window=40)
    _close(got, want.view(b, h, s, hd).transpose(1, 2), dtype)


# (B, H, Hkv, Sq, Sk, hd, causal, window): the trainer's full-width shape
# (qwen3_4b, B=4, S=1,024), recurrentgemma's window shape, the shapes of
# the other families' train steps (seamless_m4t_medium's cross-attention,
# encoder and decoder self-attention; olmoe_1b_7b's), the forward's edge
# shapes and Sk = 0
FLASH_BWD = ([(4, 32, 8, 1024, 1024, 128, True, 0),
              (1, 16, 1, 3072, 3072, 256, True, 2048),
              (4, 16, 16, 1024, 256, 64, False, 0),
              (4, 16, 16, 256, 256, 64, False, 0),
              (4, 16, 16, 1024, 1024, 64, True, 0),
              (4, 16, 16, 1024, 1024, 128, True, 0)]
             + [e for e in FLASH_EDGE if e[3] > 1]
             + [(2, 4, 2, 30, 0, 64, True, 0)])


def _flash_bwd_case(dev, dtype, b, h, hkv, sq, sk, hd, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, sq, h, hd, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, hkv, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


def _flash_bwd_plain(q, k, v, o, do, causal, window):
    from repro_torch.kernels.ref import attention_flat_bwd_plain
    b, hd = q.shape[0], q.shape[-1]

    def flat(t):
        return t.transpose(1, 2).reshape(b * t.shape[2], t.shape[1], hd)
    grads = attention_flat_bwd_plain(flat(q), flat(k), flat(v), flat(o),
                                     flat(do), causal=causal, window=window)
    return [w.reshape(b, t.shape[2], t.shape[1], hd).transpose(1, 2)
            for w, t in zip(grads, (q, k, v))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,window", FLASH_BWD)
def test_flash_bwd_kernel_vs_plain(dev, dtype, b, h, hkv, sq, sk, hd,
                                   causal, window):
    """The backward kernel against ``attention_flat_bwd_plain`` (relative
    to max(1, largest |plain gradient|)), one launch a call, two calls
    bit-equal."""
    from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                     flash_attention_bwd)
    q, k, v, do = _flash_bwd_case(dev, dtype, b, h, hkv, sq, sk, hd)
    with torch.no_grad():
        o = flash_attention_bshd(q, k, v, causal=causal, window=window)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    assert flash_attention_bwd.launches == before + 2
    assert flash_attention_bwd.source == _bwd_source(dtype, hd)
    for a, c, w in zip(got, again, _flash_bwd_plain(q, k, v, o, do, causal,
                                                    window)):
        assert a.shape == w.shape and torch.equal(a, c)
        if w.numel():
            _close(a, w, dtype)


def _bwd_source(dtype, hd):
    """The source the backward's route table picks: bf16 up to hd 128 on
    the tensor cores, the rest on the CUDA cores."""
    if dtype == torch.bfloat16 and hd <= 128:
        return "flash_attention_bwd_sm90.cu"
    return "flash_attention_bwd.cu"


# (B, H, Hkv, Sq, Sk, hd, causal, window) of the bf16 tensor-core backward:
# head dims 8, 24, 40, 64, 96, 128 (TMA pads them to 64 or 128); GQA ratios
# 1, 4 and 8; Sq and Sk not multiples of 64 or 128; Sq < Sk under the
# causal mask; windows 5 and 40; cross attention; Sk = 0
FLASH_BWD_SM90 = [(2, 4, 4, 100, 100, 8, True, 0),
                  (1, 8, 2, 130, 130, 24, True, 0),
                  (1, 8, 1, 70, 70, 40, False, 0),
                  (2, 8, 8, 200, 200, 64, True, 0),
                  (1, 8, 2, 190, 190, 96, True, 0),
                  (1, 16, 2, 257, 257, 128, True, 0),
                  (1, 4, 1, 50, 300, 128, True, 0),
                  (1, 8, 2, 200, 200, 64, True, 5),
                  (2, 4, 1, 300, 300, 96, True, 40),
                  (1, 4, 2, 65, 200, 64, False, 0),
                  (1, 8, 2, 129, 129, 128, True, 40),
                  (2, 4, 2, 30, 0, 64, True, 0)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,window", FLASH_BWD_SM90)
def test_flash_bwd_sm90_vs_plain(dev, b, h, hkv, sq, sk, hd, causal,
                                 window):
    """The bf16 tensor-core backward against ``attention_flat_bwd_plain``
    (2e-2 relative to max(1, largest |plain gradient|)), one launch a
    call, two calls bit-equal, and the source that ran."""
    from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                     flash_attention_bwd)
    q, k, v, do = _flash_bwd_case(dev, torch.bfloat16, b, h, hkv, sq, sk,
                                  hd, seed=9)
    with torch.no_grad():
        o = flash_attention_bshd(q, k, v, causal=causal, window=window)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    assert flash_attention_bwd.launches == before + 1
    assert flash_attention_bwd.source == "flash_attention_bwd_sm90.cu"
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    assert flash_attention_bwd.launches == before + 2
    for a, c, w in zip(got, again, _flash_bwd_plain(q, k, v, o, do, causal,
                                                    window)):
        assert a.shape == w.shape and torch.equal(a, c)
        if w.numel():
            _close(a, w, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_strided_views(dev, dtype):
    """``ops.flash_attention`` under grad on q, k, v sliced from one fused
    projection: forward and backward kernels once each, the gradient of
    the fused tensor equal to the plain backward's."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_flat)
    g = torch.Generator(device=dev).manual_seed(6)
    b, s, h, hkv, hd = 2, 150, 8, 2, 64
    x = torch.randn(b, s, h + 2 * hkv, hd, generator=g,
                    device=dev).to(dtype).requires_grad_()
    q, k, v = x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:]
    do = torch.randn(b, s, h, hd, generator=g, device=dev).to(dtype)
    fwd, bwd = flash_attention_flat.launches, flash_attention_bwd.launches
    o = ops.flash_attention(q, k, v, causal=True, window=40)
    (gx,) = torch.autograd.grad(o, (x,), do)
    assert flash_attention_flat.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + 1
    assert flash_attention_bwd.source == _bwd_source(dtype, hd)
    want = _flash_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(),
                            do, True, 40)
    _close(gx, torch.cat(want, dim=2), dtype)


def test_kernels_raise_under_grad_on_the_card(dev):
    """No backward kernel: on CUDA tensors under grad the wrappers raise
    (ROADMAP A8.2) instead of returning an output without a gradient."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_flat
    log_a, bv, _ = _rglru_inputs(dev, 1, 16, 32, False)
    with pytest.raises(NotImplementedError, match="A8.2"):
        ops.rglru(log_a, bv.requires_grad_())
    q, k, v = (torch.randn(1, 64, 2, 16, device=dev, requires_grad=True)
               for _ in range(3))
    gates = torch.randn(1, 64, 2, device=dev)
    with pytest.raises(NotImplementedError, match="A8.2"):
        ops.mlstm(q, k, v, gates, gates)
    cache = torch.randn(2, 32, 2, 16, device=dev)
    with pytest.raises(NotImplementedError, match="A8.2"):
        ops.decode_attention(torch.randn(2, 4, 16, device=dev,
                                         requires_grad=True), cache, cache,
                             torch.full((2,), 32, dtype=torch.int32,
                                        device=dev))
    with pytest.raises(NotImplementedError, match="ops.flash_attention"):
        flash_attention_flat(*(t[0].transpose(0, 1).contiguous()
                               for t in (q, k, v)))
    with torch.no_grad():                   # serving is untouched
        assert ops.rglru(log_a, bv).shape == log_a.shape


def test_train_steps_card_vs_cpu(dev):
    """Three steps of the qwen3_4b smoke config in float32 with remat, the
    same parameters and batches on the card and on the CPU: losses and
    grad norms within 1e-4 relative, parameters and moments within 1e-4
    x max(1, scale); on the card the attention's forward (twice a layer:
    remat) and backward kernels launch."""
    _train_card_vs_cpu(dev, "qwen3_4b")


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "pixtral_12b",
                                  "seamless_m4t_medium"])
def test_family_train_steps_card_vs_cpu(dev, arch):
    """The same for the MoE, VLM and encoder-decoder smoke configs, with
    their frontend embeddings: every attention call (seamless: encoder,
    decoder self and cross) launches the forward twice under remat and
    the backward once."""
    _train_card_vs_cpu(dev, arch)


def _train_card_vs_cpu(dev, arch):
    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_flat)
    from repro_torch.launch.shapes import frontend_tokens
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.step import build_train_step
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              dtype=torch.float32, remat=True)
    n_attn = cfg.n_layers + (cfg.n_layers + cfg.n_enc_layers
                             if cfg.family == "encdec" else 0)
    params = registry.init(cfg, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    cpu = tree_map(lambda t: t.cpu(), params)
    states = {"card": (params, adamw_init(params)),
              "cpu": (cpu, adamw_init(cpu))}
    step = build_train_step(cfg, lr_kwargs=dict(peak_lr=1e-3, warmup=1,
                                                total=10))
    fwd, bwd = flash_attention_flat.launches, flash_attention_bwd.launches
    for i in range(3):
        out = {}
        for where, d in (("card", dev), ("cpu", "cpu")):
            data = SyntheticLMData(vocab=cfg.vocab, seq_len=64,
                                   global_batch=2,
                                   frontend_dim=cfg.frontend_dim,
                                   frontend_tokens=frontend_tokens(cfg, 64),
                                   device=d)
            p, o, m = step(*states[where], i, data.batch(i))
            states[where] = (p, o)
            out[where] = m
        for key in ("loss", "grad_norm"):
            a, c = float(out["card"][key]), float(out["cpu"][key])
            assert abs(a - c) <= 1e-4 * abs(c), (i, key, a, c)
    assert flash_attention_flat.launches - fwd == 3 * 2 * n_attn
    assert flash_attention_bwd.launches - bwd == 3 * n_attn
    (pc, oc), (ph, oh) = states["card"], states["cpu"]
    for a, c in zip(tree_leaves({"p": pc, "m": oc["m"], "v": oc["v"]}),
                    tree_leaves({"p": ph, "m": oh["m"], "v": oh["v"]})):
        _close(a.cpu(), c)


# (B, H, Hkv, S, hd, lengths): "edges" is chunk - 1, chunk, chunk + 1 and
# 2 chunk for the shape's own split chunk; a length-0 row among full rows,
# lengths above S (clamped), qpk = 1, the MQA ring buffer;
# seamless_m4t_medium's self cache (MHA, hd 64) and its cross cache, every
# frame valid
DECODE_EDGE = [(4, 32, 8, 1056, 128, "edges"),
               (4, 16, 1, 2048, 256, "edges"),
               (4, 32, 8, 1056, 128, [1056, 0, 1056, 1056]),
               (3, 8, 2, 300, 64, [301, 5000, 300]),
               (2, 8, 8, 300, 128, [299, 3]),
               (3, 4, 2, 100, 32, [0, 0, 0]),
               (4, 16, 16, 1056, 64, [1025, 1035, 1045, 1055]),
               (4, 16, 16, 256, 64, [256] * 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,hd,lens", DECODE_EDGE)
def test_decode_kernel_vs_plain(dev, dtype, b, h, hkv, s, hd, lens):
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      split_chunk)
    from repro_torch.kernels.ref import decode_attention_plain
    if lens == "edges":
        c = split_chunk(b, hkv, s)
        lens = [c - 1, c, c + 1, 2 * c]
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(b, h, hd, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, s, hkv, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    got = decode_attention(q, k, v, lengths)
    assert decode_attention.launches == before + 1
    _close(got, decode_attention_plain(q, k, v, lengths), dtype)
    for row, n in enumerate(lens):
        if n <= 0:
            assert not bool(got[row].any())


# ------------------------------------------------- the engine's two kernels
#
# Both are integer: bit-equal to their plain versions, or wrong.  Each
# call must be one device operation (one kernel record, no fill, no
# memset); the profiler keeps only some records of a kernel launched
# through ctypes, so the check is on the records' names and their count
# over many calls, never on one record.

INF = 2**30


def _device_records(fn, calls=40):
    """{device record name: count} over ``calls`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _minskew_inputs(dev, v, n, s, seed=0, offset=0):
    """chip_smoke's recipe: ~10% INF vtimes, ~70% runnable, every vtask
    in scope i % S and every 7th also in (i + 1) % S.  ``offset`` > 0
    places membership ``offset`` bytes into its buffer (not 16-byte
    aligned)."""
    rng = np.random.default_rng(seed)
    vt = rng.integers(0, 1_000_000, (v, n)).astype(np.int32)
    vt[rng.random((v, n)) < 0.1] = INF
    run = (rng.random((v, n)) < 0.7).astype(np.int8)
    mem = np.zeros((n, s), np.int8)
    idx = np.arange(n)
    if s:
        mem[idx, idx % s] = 1
        sev = idx[idx % 7 == 0]
        mem[sev, (sev + 1) % s] = 1
    mem = np.broadcast_to(mem, (v, n, s)).copy()
    skew = rng.integers(0, 50_000, (v, s)).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (vt, run, mem, skew)]
    if offset:
        buf = torch.zeros(t[2].numel() + offset, dtype=torch.int8,
                          device=dev)
        buf[offset:] = t[2].reshape(-1)
        t[2] = buf[offset:].view(v, n, s)
    return t


def _minskew_equal(t, cluster=None):
    from repro_torch.kernels import minskew as km
    from repro_torch.kernels.ref import minskew_plain
    before = km.minskew.launches
    got = (km.minskew(*t) if cluster is None
           else km._launch(*t, cluster=cluster))
    if cluster is None and t[2].numel():
        assert km.minskew.launches == before + 1
    want = minskew_plain(*t)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got


#: chip_smoke's shapes; the main-path campaign's sweep; the sweep's
#: variant axis; R > N; S a multiple of 16 below one group a lane; S
#: above one chunk of scopes
@pytest.mark.parametrize("v,n,s", [(1, 16_384, 1), (1, 16_384, 256),
                                   (8, 4_096, 64), (32, 16_384, 1),
                                   (64, 16, 3), (1, 5, 3),
                                   (3, 33, 16), (2, 700, 2_100),
                                   (1, 100_000, 48)])
def test_minskew_kernel_vs_plain(dev, v, n, s):
    _minskew_equal(_minskew_inputs(dev, v, n, s))


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("v,n,s,offset", [(2, 1_000, 48, 0),
                                          (2, 1_000, 48, 1),
                                          (1, 7, 1, 0), (3, 2_000, 5, 0)])
def test_minskew_every_cluster_size(dev, cluster, v, n, s, offset):
    _minskew_equal(_minskew_inputs(dev, v, n, s, offset=offset), cluster)


def test_minskew_edge_cases(dev):
    """tests/test_torch_kernels.py's edge cases: all masked, an empty
    scope, sentinel vtimes, the int32 boundary, 1x1 and 3x2, and the
    axes of size 0 (answered on the host)."""
    rng = np.random.default_rng(3)

    def case(vt, run, mem, skew):
        t = [torch.tensor(np.asarray(x)[None], dtype=d, device=dev)
             for x, d in ((vt, torch.int32), (run, torch.int8),
                          (mem, torch.int8), (skew, torch.int32))]
        return _minskew_equal(t)
    minima, elig = case(rng.integers(0, 10_000, 40), np.zeros(40),
                        rng.random((40, 6)) < 0.4, rng.integers(1, 500, 6))
    assert bool((minima == INF).all()) and not bool(elig.any())
    mem = rng.random((24, 4)) < 0.5
    mem[:, 2] = False
    minima, _ = case(rng.integers(0, 10_000, 24), np.ones(24), mem,
                     np.zeros(4))
    assert int(minima[0, 2]) == INF
    vt = rng.integers(0, 10_000, 16)
    vt[::2] = INF
    run = np.ones(16)
    run[::2] = 0
    case(vt, run, np.ones((16, 3)), rng.integers(1, 100, 3))
    _, elig = case(INF - 1 - rng.integers(0, 2_000, 12), np.ones(12),
                   np.ones((12, 2)), np.full(2, 5_000))
    assert bool(elig.all())
    case([7], [1], [[1]], [0])
    case(rng.integers(0, 100, 3), [1, 0, 1], rng.random((3, 2)) < 0.5,
         [10, 20])
    for v, n, s in ((0, 4, 3), (2, 0, 3), (2, 4, 0)):
        _minskew_equal(_minskew_inputs(dev, v, n, s))


def test_minskew_variants_past_one_launch(dev):
    """More variants than a launch's grid takes: one launch for every
    ``MAX_V``, with 16-byte membership loads (S = 16) and without
    (S = 1), bit-equal to the plain version."""
    from repro_torch.kernels import minskew as km
    from repro_torch.kernels.ref import minskew_plain
    for v, n, s in ((km.MAX_V + 3, 4, 16), (km.MAX_V + 1, 3, 1)):
        t = _minskew_inputs(dev, v, n, s)
        before = km.minskew.launches
        got = km.minskew(*t)
        assert km.minskew.launches == before + 2
        want = minskew_plain(*t)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_minskew_sizes_in_sequence_and_twice(dev):
    """Calls that grow and shrink V*N*S, each bit-equal, and two calls
    on the same inputs give the same bits."""
    for v, n, s in ((1, 16_384, 1), (8, 4_096, 64), (1, 3, 2),
                    (1, 16_384, 256), (64, 16, 3), (1, 16_384, 1)):
        t = _minskew_inputs(dev, v, n, s, seed=v + n + s)
        a = _minskew_equal(t)
        b = _minskew_equal(t)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("v,n,s", [(1, 16_384, 1), (8, 4_096, 64)])
def test_minskew_one_device_operation_a_call(dev, v, n, s):
    from repro_torch.kernels.minskew import minskew
    t = _minskew_inputs(dev, v, n, s)
    seen = _device_records(lambda: minskew(*t))
    assert seen and all("minskew_cluster_kernel" in k for k in seen), seen
    assert sum(seen.values()) <= 40, seen


def _hub_inputs(dev, m, n_links, one_per_link=False, offset=0, seed=1,
                ser_hi=10_000):
    """chip_smoke's recipe: messages sorted by (link, send), durations
    below ``ser_hi``, ~20% of them 163.  A link's summed durations must
    stay within int32, the function's domain (a queue that ends past
    2^31 ns has no int32 answer), so one link for a million messages
    takes ``ser_hi`` 1,000.  ``offset`` places each array ``offset``
    int32s into its buffer (not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    link = (np.arange(m) if one_per_link
            else np.sort(rng.integers(0, n_links, m))).astype(np.int32)
    send = rng.integers(0, 1_000_000, m).astype(np.int32)
    order = np.lexsort((send, link))
    send, link = send[order], link[order]
    ser = rng.integers(0, ser_hi, m).astype(np.int32)
    ser[rng.random(m) < 0.2] = 163
    lat = rng.integers(0, 5_000, n_links).astype(np.int32)
    out = []
    for x in (send, ser, link):
        buf = torch.zeros(m + offset, dtype=torch.int32, device=dev)
        buf[offset:] = torch.from_numpy(x).to(dev)
        out.append(buf[offset:])
    return out + [torch.from_numpy(lat).to(dev)]


def _hub_equal(t):
    from repro_torch.kernels.hub_route import hub_route
    from repro_torch.kernels.ref import hub_route_plain
    send, ser, link, lat = t
    before = hub_route.launches
    ones = torch.ones(lat.shape[0], device=send.device)
    got = hub_route(send, ser, link, ones, lat, ser_ns=ser)
    assert hub_route.launches == before + (1 if send.numel() else 0)
    want = hub_route_plain(send, ser, link, lat)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return got


TILE = 1024


#: chip_smoke's main and large shapes, one link for every message (the
#: longest look-back), one message a link, M around a tile, and
#: pointers that are not 16-byte aligned
@pytest.mark.parametrize("m,links,one,offset,ser_hi", [
    (65_600, 16_416, False, 0, 10_000), (1 << 20, 4_096, False, 0, 10_000),
    (1 << 20, 1, False, 0, 1_000), (4_099, 4_099, True, 0, 10_000),
    (1, 1, False, 0, 10_000), (7, 1, False, 0, 10_000),
    (129, 1, False, 0, 10_000), (TILE - 1, 3, False, 0, 10_000),
    (TILE, 1, False, 0, 10_000), (TILE + 1, 2, False, 0, 10_000),
    (65_600, 16_416, False, 1, 10_000), (3 * TILE + 5, 1, False, 3, 10_000)])
def test_hub_kernel_vs_plain(dev, m, links, one, offset, ser_hi):
    from repro_torch.kernels import hub_route as kh
    assert kh.TILE == TILE
    _hub_equal(_hub_inputs(dev, m, links, one, offset, ser_hi=ser_hi))


def test_hub_sizes_in_sequence_and_twice(dev):
    """Shrinking and growing M on one stream (stale flags of a larger
    call under a smaller one; the scratch grown past its first
    capacity), each call bit-equal and each twice the same bits."""
    for m, links in ((65_600, 16_416), (7, 1), (1, 1), (1 << 20, 4_096),
                     (65_600, 16_416), (9_000_000, 1), (7, 1),
                     (65_600, 16_416)):
        t = _hub_inputs(dev, m, links, seed=m,
                        ser_hi=min(10_000, 2**30 // m))
        assert torch.equal(_hub_equal(t), _hub_equal(t))


def test_hub_float32_pin(dev):
    from repro_torch.kernels.hub_route import hub_route
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    size = torch.tensor([163], dtype=torch.int32, device=dev)
    bw = torch.tensor([1e9], dtype=torch.float32, device=dev)
    assert int(hub_route(z, size, z, bw, z)[0]) == 162
    assert int(hub_route(z, size, z, bw, z, ser_ns=size)[0]) == 163


@pytest.mark.parametrize("m,links", [(65_600, 16_416), (1 << 20, 4_096)])
def test_hub_one_device_operation_a_call(dev, m, links):
    from repro_torch.kernels.hub_route import hub_route
    send, ser, link, lat = _hub_inputs(dev, m, links)
    ones = torch.ones(links, device=dev)
    seen = _device_records(
        lambda: hub_route(send, ser, link, ones, lat, ser_ns=ser))
    assert seen and all("hub_lookback_kernel" in k for k in seen), seen
    assert sum(seen.values()) <= 40, seen
