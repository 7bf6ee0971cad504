"""`repro_torch` — the PyTorch + CUDA port of LiveStack.

The JAX package `repro` is the reference; this package mirrors its
module layout and imports neither JAX nor anything of `repro`.  Ported
so far: the pure-Python simulation substrate (`repro_torch.core`), the
declarative facade (`repro_torch.sim`), and the vectorized engine with
its two hand-written CUDA kernels (`repro_torch.kernels`)."""
