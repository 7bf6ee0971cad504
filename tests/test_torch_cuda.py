"""The port's kernels and models on the card, against their plain
versions, and the training path's gradient (the flash and recurrent
backward kernels, three train steps of each trained family against the
CPU, decode's raise under grad).  Marked ``cuda``: without a CUDA card
every test skips (decided in the fixture, not at import).  This file
imports neither JAX nor the JAX package, so it runs on a machine with
the card alone:

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
#: ||got - want|| / ||want|| of each recurrent-backward gradient, per
#: dtype (chip_smoke.ATTN_BWD_REL_NORM)
REL_NORM = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
       (torch.bfloat16, 1, 64, 2880, True),
       (torch.float32, 2, 200, 1024, True)])
def test_mlstm_kernel_vs_plain(dev, dtype, bh, s, hd, carry):
    from repro_torch.kernels.mlstm_kernel import (fwd_source,
                                                  mlstm_chunkwise,
                                                  mlstm_flat_plain)
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
    assert mlstm_chunkwise.source == fwd_source(dtype, hd)
    again = mlstm_chunkwise(q, k, v, ig, fg, c0, n0)
    assert torch.equal(h, again[0]) and torch.equal(c, again[1][0])
    hw, (cw, nw) = mlstm_flat_plain(q, k, v, ig, fg, c0, n0)
    _close(h, hw, dtype)
    _close(c, cw)
    _close(n, nw)


#: S = 1, S off the chunk of 256 with odd W, h0 given and not, a chain
#: of 16 chunks, the 4-byte copies (W % 4 != 0) without h0, S one step
#: either side of the chunk, train_parity_rglru's shape, and a long chain
#: of 64 chunks (where the chain is the critical path)
@pytest.mark.parametrize("b,s,w,with_h0", [(2, 1, 64, True),
                                           (2, 300, 32, False),
                                           (2, 515, 4099, True),
                                           (1, 4096, 256, True),
                                           (1, 300, 37, False),
                                           (2, 255, 64, True),
                                           (2, 257, 64, False),
                                           (2, 128, 4096, False),
                                           (1, 16384, 1024, True)])
def test_rglru_bwd_kernel_vs_plain(dev, b, s, w, with_h0):
    """``csrc/rglru_scan_bwd.cu`` against ``ref.rglru_bwd_plain``; a
    second call gives the same bits."""
    from repro_torch.kernels.ref import rglru_bwd_plain, rglru_plain
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    log_a, bv, h0 = _rglru_inputs(dev, b, s, w, with_h0)
    h = rglru_plain(log_a, bv, h0)
    dh = torch.randn(b, s, w, generator=torch.Generator(device=dev)
                     .manual_seed(4), device=dev)
    before = rglru_scan_bwd.launches
    got = rglru_scan_bwd(log_a, h, h0, dh)
    assert rglru_scan_bwd.launches == before + 1
    want = rglru_bwd_plain(log_a, h, h0, dh)
    assert (got[2] is None) == (h0 is None)
    for g, wt in zip(got, want):
        if wt is not None:
            _close(g, wt)
    again = rglru_scan_bwd(log_a, h, h0, dh)
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))


def test_rglru_bwd_with_a_detached_h0(dev):
    """A carried h0 that takes no gradient: autograd through
    ``ops.rglru`` launches the backward kernel once, with h0 as h_{-1}
    (dlog_a_0 = g_0 a_0 h0), and gives log_a and b the plain version's
    gradients."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rglru_plain
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    log_a, bv, h0 = _rglru_inputs(dev, 2, 300, 40, True)
    ins = [t.requires_grad_() for t in (log_a, bv)]
    dh = torch.randn(2, 300, 40, generator=torch.Generator(device=dev)
                     .manual_seed(6), device=dev)
    before = rglru_scan_bwd.launches
    got = torch.autograd.grad(ops.rglru(log_a, bv, h0), ins, dh)
    assert rglru_scan_bwd.launches == before + 1
    want = torch.autograd.grad(rglru_plain(log_a, bv, h0), ins, dh)
    assert float(want[0][:, 0].abs().max()) > 0
    for g, w in zip(got, want):
        _close(g, w)


def _mlstm_bwd_inputs(dev, dtype, bh, s, hd, carry, final, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dh = (torch.randn(bh, s, hd, generator=g, device=dev).mul(0.3)
                   .to(dtype) for _ in range(4))
    ig = torch.randn(bh, s, generator=g, device=dev)
    ig[0, s // 2] = 9.5                     # above the cap: no gradient
    fg = torch.randn(bh, s, generator=g, device=dev) + 2.0
    c0, n0, dc, dn = ((torch.randn(*shape, generator=g, device=dev) * 0.1
                       if on else None)
                      for on, shape in ((carry, (bh, hd, hd)),
                                        (carry, (bh, hd)),
                                        (final, (bh, hd, hd)),
                                        (final, (bh, hd))))
    return q, k, v, ig, fg, c0, n0, dh, dc, dn


#: (BH, S, hd, initial carry, final-state gradients): S off the chunk of
#: 64, hd off the tile of 64, the two kinds of carry each alone and
#: together, and xlstm's head dim; in either dtype every shape runs a
#: tensor-core backward but hd 100 (not a multiple of 8: the first
#: design), and hd 96 runs it with a column block half past hd
MLSTM_BWD_SHAPES = [(2, 200, 64, True, True), (3, 128, 32, False, False),
                    (1, 70, 100, True, False), (2, 64, 8, False, True),
                    (2, 256, 1024, True, True), (1, 130, 96, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,hd,carry,final", MLSTM_BWD_SHAPES)
def test_mlstm_bwd_kernel_vs_plain(dev, dtype, bh, s, hd, carry, final):
    """The backward kernel its dtype and head dim pick
    (``mlstm_kernel.bwd_source``: ``csrc/mlstm_kernel_bwd_sm90.cu`` for
    bf16 and ``csrc/mlstm_kernel_bwd_tf32x3.cu`` for float32 at hd a
    multiple of 8 up to their limits, else ``csrc/mlstm_kernel_bwd.cu``)
    against
    ``ref.mlstm_chunkwise_bwd_plain`` in both dtypes (each gradient within
    the dtype's tolerance of its largest |plain value|, and by its
    relative norm); a second call gives the same bits."""
    from repro_torch.kernels.mlstm_kernel import (BWD_SM90, bwd_source,
                                                  mlstm_chunkwise_bwd)
    from repro_torch.kernels.ref import mlstm_chunkwise_bwd_plain
    args = _mlstm_bwd_inputs(dev, dtype, bh, s, hd, carry, final)
    before = mlstm_chunkwise_bwd.launches
    got = mlstm_chunkwise_bwd(*args)
    assert mlstm_chunkwise_bwd.launches == before + 1
    source = bwd_source(dtype, hd)
    assert mlstm_chunkwise_bwd.source == source
    want = mlstm_chunkwise_bwd_plain(*args)
    parts = ("dq", "dk", "dv", "di_raw", "df_raw", "dc0", "dn0")
    for part, g, w in zip(parts, [x for gg in got for x in gg],
                          [x for ww in want for x in ww]):
        err = float((g.float() - w.float()).abs().max())
        scale = max(1.0, float(w.float().abs().max()))
        # the first design and the split-TF32 one keep float32 accuracy,
        # so their float32 outputs meet float32's tolerance in either
        # dtype; the bf16 tensor-core design rounds operands to bf16 (S /
        # m, dS~, C, dC'), so each of its gradients is held to bf16's
        tol = TOL[dtype] if source == BWD_SM90 else TOL[g.dtype]
        assert err <= tol * scale, (part, err, scale)
        diff = float(torch.linalg.vector_norm(g.float() - w.float()))
        norm = float(torch.linalg.vector_norm(w.float()))
        rel = diff / norm if norm > 0 else diff
        assert rel <= REL_NORM[dtype], (part, rel)
    assert bool((got[1][0][args[3] > 8.0] == 0).all())
    again = mlstm_chunkwise_bwd(*args)
    assert all(torch.equal(a, c) for gg, aa in zip(got, again)
               for a, c in zip(gg, aa))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [(2, 128), (4, 1)])
def test_one_shard_moe_is_the_unsharded_dispatch(dev, dtype, tokens):
    """olmoe_1b_7b's MoE layer at full width on the card, a prefill of
    2 x 128 tokens (capacity 40: slots drop) and a decode step of 4:
    ``moe_ffn_reference``, and ``moe_ffn`` under a (1, 1) mesh, equal
    the dispatch on (T, D) with no shard axis (``tests/moe_dispatch_2d.py``)
    bit for bit, outputs, aux loss and gradients."""
    from moe_dispatch_2d import grads, moe_2d

    from repro_torch import configs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import ctx
    cfg = dataclasses.replace(configs.get("olmoe_1b_7b"), dtype=dtype)
    p = {k: v[0] for k, v in moe.moe_params(
        torch.Generator(device=dev).manual_seed(4), cfg, 1,
        device=dev).items()}
    x = torch.randn(*tokens, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5)
                    ).to(dtype)
    want = grads(moe_2d, cfg, p, x)
    with ctx.use_mesh(make_test_mesh(1, 1)):
        on_mesh = grads(moe.moe_ffn, cfg, p, x)
    for got in (grads(moe.moe_ffn_reference, cfg, p, x), on_mesh):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(got[2][n], g) for n, g in want[2].items())


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
    from repro_torch.kernels.flash_attention import (flash_attention_flat,
                                                     fwd_source)
    from repro_torch.kernels.ref import attention_flat_plain
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b * h, sq, hd, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b * hkv, sk, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = flash_attention_flat.launches
    by_source = dict(flash_attention_flat.launches_by_source)
    source = fwd_source(dtype, hd)
    got = flash_attention_flat(q, k, v, causal=causal, window=window)
    assert flash_attention_flat.launches == before + 1
    assert (flash_attention_flat.launches_by_source[source]
            == by_source.get(source, 0) + 1)
    _close(got, attention_flat_plain(q, k, v, causal=causal, window=window),
           dtype)
    if dtype == torch.float32:          # no atomics: the same bits again
        assert torch.equal(got, flash_attention_flat(q, k, v, causal=causal,
                                                     window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fused", "heads_first"])
def test_flash_strided_views_vs_plain(dev, dtype, kind):
    """``ops.flash_attention`` on non-contiguous (B, S, H, hd) views (both
    dtypes' kernels read them in place) against the plain version of
    contiguous copies."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_flat,
                                                     fwd_source)
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
    source = fwd_source(dtype, hd)
    before = flash_attention_flat.launches_by_source.get(source, 0)
    got = ops.flash_attention(q, k, v, causal=True, window=40)
    assert flash_attention_flat.launches_by_source[source] == before + 1
    want = attention_flat_plain(
        *(t.transpose(1, 2).reshape(-1, s, hd).contiguous()
          for t in (q, k, v)), causal=True, window=40)
    _close(got, want.view(b, h, s, hd).transpose(1, 2), dtype)
    if dtype == torch.float32:          # no atomics: the same bits again
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=True,
                                                    window=40))


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
    """The source the backward's route table (``bwd_source``) picks: bf16
    on ``wgmma``, float32 as split TF32 ``mma.sync``, both on the tensor
    cores."""
    from repro_torch.kernels.flash_attention import bwd_source
    return bwd_source(dtype, hd)


# (B, H, Hkv, Sq, Sk, hd, causal, window) of the bf16 tensor-core backward:
# head dims 8, 24, 40, 64, 96, 128 (TMA pads them to 64 or 128); GQA ratios
# 1, 4 and 8; Sq and Sk not multiples of 64 or 128; Sq < Sk under the
# causal mask; windows 5 and 40; cross attention; Sk = 0; above hd 128
# (padded to 256, columns split, heads split over blocks): MQA at 16/1
# heads with a binding window, 6 heads a group (split unevenly on an
# H100's 132 SMs: 4 parts), hd 192, hd 136 with Sq < Sk, and Sk = 0
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
                  (2, 4, 2, 30, 0, 64, True, 0),
                  (1, 16, 1, 300, 300, 256, True, 100),
                  (2, 12, 2, 1024, 1024, 256, True, 0),
                  (1, 8, 2, 200, 200, 192, True, 0),
                  (1, 4, 2, 70, 300, 136, True, 0),
                  (2, 4, 1, 30, 0, 256, True, 0)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,window", FLASH_BWD_SM90)
def test_flash_bwd_sm90_vs_plain(dev, b, h, hkv, sq, sk, hd, causal,
                                 window):
    """The bf16 tensor-core backward against ``attention_flat_bwd_plain``
    (2e-2 relative to max(1, largest |plain gradient|)), one launch a
    call, two calls bit-equal, and the source and head parts that ran."""
    from repro_torch.kernels.flash_attention import (bwd_head_parts,
                                                     flash_attention_bshd,
                                                     flash_attention_bwd)
    q, k, v, do = _flash_bwd_case(dev, torch.bfloat16, b, h, hkv, sq, sk,
                                  hd, seed=9)
    with torch.no_grad():
        o = flash_attention_bshd(q, k, v, causal=causal, window=window)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    assert flash_attention_bwd.launches == before + 1
    assert flash_attention_bwd.source == "flash_attention_bwd_sm90.cu"
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert flash_attention_bwd.head_parts == bwd_head_parts(b, h, hkv, sk,
                                                            hd, n_sm)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    assert flash_attention_bwd.launches == before + 2
    for a, c, w in zip(got, again, _flash_bwd_plain(q, k, v, o, do, causal,
                                                    window)):
        assert a.shape == w.shape and torch.equal(a, c)
        if w.numel():
            _close(a, w, torch.bfloat16)


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal,window", FLASH_BWD_SM90)
def test_flash_bwd_tf32x3_vs_plain(dev, b, h, hkv, sq, sk, hd, causal,
                                   window):
    """The float32 backward (``csrc/flash_attention_bwd_tf32x3.cu``, split
    TF32 on the tensor cores) at every shape of the bf16 cases: each
    gradient within 1e-4 x max(1, its largest |plain value|) and
    ``||got - want|| / ||want||`` within 1e-4 of
    ``attention_flat_bwd_plain``, one launch a call, two calls bit-equal,
    and the source and head parts that ran."""
    from repro_torch.kernels.flash_attention import (bwd_head_parts,
                                                     flash_attention_bshd,
                                                     flash_attention_bwd)
    q, k, v, do = _flash_bwd_case(dev, torch.float32, b, h, hkv, sq, sk,
                                  hd, seed=10)
    with torch.no_grad():
        o = flash_attention_bshd(q, k, v, causal=causal, window=window)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    assert flash_attention_bwd.launches == before + 1
    assert flash_attention_bwd.source == "flash_attention_bwd_tf32x3.cu"
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert flash_attention_bwd.head_parts == bwd_head_parts(b, h, hkv, sk,
                                                            hd, n_sm)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    for a, c, w in zip(got, again, _flash_bwd_plain(q, k, v, o, do, causal,
                                                    window)):
        assert a.shape == w.shape and torch.equal(a, c)
        if w.numel():
            _close(a, w)
            rel = float(torch.linalg.vector_norm(a - w)
                        / torch.linalg.vector_norm(w).clamp_min(1e-30))
            assert rel <= REL_NORM[torch.float32], rel


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
    """Under grad on CUDA tensors the recurrences go through their
    backward kernels (each call of ``ops.rglru`` and ``ops.mlstm`` raises
    its backward counter by exactly 1, with the plain version's
    gradients); decode, which nothing trains through, and the flat
    attention entry point raise instead of returning an output without a
    gradient."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_flat
    from repro_torch.kernels.mlstm_kernel import (mlstm_chunkwise_bwd,
                                                  mlstm_flat_plain)
    from repro_torch.kernels.ref import rglru_plain
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    log_a, bv, h0 = _rglru_inputs(dev, 1, 300, 40, True)
    ins = [t.requires_grad_() for t in (log_a, bv, h0)]
    dh = torch.randn(1, 300, 40, device=dev)
    before = rglru_scan_bwd.launches
    got = torch.autograd.grad(ops.rglru(*ins), ins, dh)
    assert rglru_scan_bwd.launches == before + 1
    for g, w in zip(got, torch.autograd.grad(rglru_plain(*ins), ins, dh)):
        _close(g, w)
    q, k, v = (torch.randn(1, 100, 2, 16, device=dev, requires_grad=True)
               for _ in range(3))
    gates = [torch.randn(1, 100, 2, device=dev, requires_grad=True)
             for _ in range(2)]
    do = torch.randn(1, 100, 2, 16, device=dev)
    before = mlstm_chunkwise_bwd.launches
    got = torch.autograd.grad(ops.mlstm(q, k, v, *gates)[0],
                              [q, k, v, *gates], do)
    assert mlstm_chunkwise_bwd.launches == before + 1

    def flat(t):
        return t.transpose(1, 2).reshape(2, *t.shape[1:2], *t.shape[3:])
    want = torch.autograd.grad(
        mlstm_flat_plain(*(flat(t) for t in (q, k, v, *gates)))[0],
        [q, k, v, *gates], flat(do))
    for g, w in zip(got, want):
        _close(g, w)
    cache = torch.randn(2, 32, 2, 16, device=dev)
    with pytest.raises(NotImplementedError, match="A8.2"):
        ops.decode_attention(torch.randn(2, 4, 16, device=dev,
                                         requires_grad=True), cache, cache,
                             torch.full((2,), 32, dtype=torch.int32,
                                        device=dev))
    with pytest.raises(NotImplementedError, match="ops.flash_attention"):
        flash_attention_flat(*(t[0].transpose(0, 1).contiguous()
                               for t in (q, k, v)))
    with torch.no_grad():                   # serving saves nothing
        before = rglru_scan_bwd.launches
        assert ops.rglru(log_a, bv).grad_fn is None
        assert rglru_scan_bwd.launches == before


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


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_1_3b"])
def test_recurrent_train_steps_card_vs_cpu(dev, arch):
    """The same for the recurrent smoke configs: recurrentgemma's
    ``rglru_scan`` and attention, xlstm's ``mlstm_chunkwise`` (its sLSTM
    has no kernel), each forward twice a layer under remat and each
    backward once; the gradients of every parameter on the card within
    tolerance of the CPU's."""
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
    from repro_torch.kernels.mlstm_kernel import (mlstm_chunkwise,
                                                  mlstm_chunkwise_bwd)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch.train.step import build_train_step, grads_of
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              dtype=torch.float32, remat=True)
    n_attn = cfg.n_layers + (cfg.n_layers + cfg.n_enc_layers
                             if cfg.family == "encdec" else 0)
    n_rec = n_mlstm = 0
    if cfg.family == "rglru":
        from repro_torch.models.rglru import layer_kinds
        n_attn = layer_kinds(cfg).count("attn")
        n_rec = cfg.n_layers - n_attn
    elif cfg.family == "xlstm":
        from repro_torch.models.xlstm import is_slstm
        n_attn = 0
        n_mlstm = sum(not is_slstm(cfg, i) for i in range(cfg.n_layers))
    # (forward wrapper, backward wrapper, calls a forward)
    counted = ((flash_attention_flat, flash_attention_bwd, n_attn),
               (rglru_scan, rglru_scan_bwd, n_rec),
               (mlstm_chunkwise, mlstm_chunkwise_bwd, n_mlstm))
    params = registry.init(cfg, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    cpu = tree_map(lambda t: t.cpu(), params)
    states = {"card": (params, adamw_init(params)),
              "cpu": (cpu, adamw_init(cpu))}
    step = build_train_step(cfg, lr_kwargs=dict(peak_lr=1e-3, warmup=1,
                                                total=10))
    if n_rec or n_mlstm:                    # every leaf's gradient
        data = SyntheticLMData(vocab=cfg.vocab, seq_len=100, global_batch=2,
                               device="cpu").batch(0)
        got, _ = grads_of(cfg, params, data["tokens"].to(dev),
                          data["labels"].to(dev), None)
        want, _ = grads_of(cfg, cpu, data["tokens"], data["labels"], None)
        for a, c in zip(tree_leaves(got), tree_leaves(want)):
            _close(a.cpu(), c)
    before = [(f.launches, b.launches) for f, b, _ in counted]
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
    for (f, b, n), (f0, b0) in zip(counted, before):
        assert (f.launches - f0, b.launches - b0) == (3 * 2 * n, 3 * n), f
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


def _device_records(fn, calls=40, windows=5):
    """{device record name: count} over ``calls`` calls of ``fn``.  Now
    and then the profiler keeps no record in a window, which shows
    nothing either way, so an empty window is taken again, up to
    ``windows`` times (as chip_smoke's ``one_device_op``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
        if seen:
            return seen
    return seen


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


class _Allocations:
    """Every operation's tensor results, (name, shape, dtype) in order,
    while active: the same call on the card and on meta tensors must
    allocate the same outputs and workspaces."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                outs = out if isinstance(out, (list, tuple)) else [out]
                seen.extend((func.__name__, tuple(t.shape), t.dtype)
                            for t in outs if isinstance(t, torch.Tensor))
                return out
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _route_calls(device, dtype, hd):
    """One call of each model-path kernel (forward and backward) on
    tensors of ``device``, seeded; returns {kernel: (allocations, result
    shapes and dtypes)}."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)

    def t(*shape, dt=dtype, grad=False):
        x = torch.randn(*shape, generator=g).to(dt).to(device)
        return x.requires_grad_(grad)
    out = {}

    def run(name, fn):
        with _Allocations() as rec:
            res = fn()
        res = res if isinstance(res, (list, tuple)) else [res]
        flat = [r for x in res for r in (x if isinstance(x, tuple) else [x])]
        out[name] = (rec.seen, [(tuple(r.shape), r.dtype) for r in flat
                                if isinstance(r, torch.Tensor)])
    b, s, h, hkv = 2, 200, 8, 2
    q, k, v = t(b, s, h, hd, grad=True), t(b, s, hkv, hd, grad=True), \
        t(b, s, hkv, hd, grad=True)
    o = ops.flash_attention(q, k, v, causal=True)
    run("flash_fwd", lambda: ops.flash_attention(q.detach(), k.detach(),
                                                 v.detach(), causal=True))
    do = t(b, s, h, hd)
    run("flash_bwd", lambda: torch.autograd.grad(o, (q, k, v), do,
                                                 retain_graph=True))
    lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    run("decode", lambda: ops.decode_attention(
        t(b, h, hd), t(b, s, hkv, hd), t(b, s, hkv, hd), lengths))
    la, bb = (t(b, s, 70, dt=torch.float32, grad=True) for _ in range(2))
    hs = ops.rglru(la, bb)
    run("rglru_fwd", lambda: ops.rglru(la.detach(), bb.detach()))
    run("rglru_bwd", lambda: torch.autograd.grad(hs.sum(), (la, bb)))
    qm, km, vm = (t(b, s, 2, hd, grad=True) for _ in range(3))
    ig, fg = (t(b, s, 2, dt=torch.float32, grad=True) for _ in range(2))
    hm, _ = ops.mlstm(qm, km, vm, ig, fg)
    run("mlstm_fwd", lambda: ops.mlstm(qm.detach(), km.detach(), vm.detach(),
                                       ig.detach(), fg.detach()))
    run("mlstm_bwd", lambda: torch.autograd.grad(
        hm.float().sum(), (qm, km, vm, ig, fg)))
    return out


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.float32, 64),
                                      (torch.bfloat16, 256),
                                      (torch.float32, 256)])
def test_meta_route_allocates_as_the_card(dev, dtype, hd):
    """The meta route (``repro_torch.kernels.work``) and the CUDA route
    of each model-path kernel on the same call: the same operations'
    results (outputs, workspaces, scratch) in the same shapes and dtypes,
    and the same results; the meta route moves no launch counter.  hd 256
    splits the attention backward's heads (a float32 workspace)."""
    from repro_torch.kernels import flash_attention as fmod
    card = _route_calls(dev, dtype, hd)
    before = fmod.flash_attention_flat.launches
    meta = _route_calls(torch.device("meta"), dtype, hd)
    assert fmod.flash_attention_flat.launches == before
    assert card.keys() == meta.keys()
    for name in card:
        (got, got_res), (want, want_res) = meta[name], card[name]
        at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                  min(len(got), len(want)))
        assert got == want, (name, at, got[at:at + 3], want[at:at + 3])
        assert got_res == want_res, name
