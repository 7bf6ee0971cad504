"""The port's recurrent kernels and models on the card, against their
plain versions.  Marked ``cuda``: without a CUDA card every test skips
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


# (B, H, Hkv, Sq, Sk, hd, causal, window): head dims that are not multiples
# of 16 (the bf16 kernel pads them to 64), one query row, fewer queries
# than keys under the causal mask, a window narrower than a key tile,
# cross attention, MQA at hd 256 with a window
FLASH_EDGE = [(2, 4, 2, 100, 100, 8, True, 0),
              (1, 4, 1, 130, 130, 24, True, 0),
              (1, 4, 2, 70, 70, 40, False, 0),
              (2, 4, 2, 1, 1, 64, True, 0),
              (2, 4, 2, 1, 77, 64, False, 0),
              (1, 4, 2, 50, 300, 128, True, 0),
              (1, 4, 2, 200, 200, 64, True, 5),
              (1, 2, 2, 64, 192, 32, False, 0),
              (1, 4, 1, 300, 300, 256, True, 100)]


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


# (B, H, Hkv, S, hd, lengths): "edges" is chunk - 1, chunk, chunk + 1 and
# 2 chunk for the shape's own split chunk; a length-0 row among full rows,
# lengths above S (clamped), qpk = 1, the MQA ring buffer
DECODE_EDGE = [(4, 32, 8, 1056, 128, "edges"),
               (4, 16, 1, 2048, 256, "edges"),
               (4, 32, 8, 1056, 128, [1056, 0, 1056, 1056]),
               (3, 8, 2, 300, 64, [301, 5000, 300]),
               (2, 8, 8, 300, 128, [299, 3]),
               (3, 4, 2, 100, 32, [0, 0, 0])]


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
