"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352, head_dim=128, rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi3-medium-14b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16,
)
