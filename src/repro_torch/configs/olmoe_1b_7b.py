"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304, head_dim=128, rope_theta=10_000.0,
    n_experts=64, top_k=8,
)

SMOKE = dataclasses.replace(
    CONFIG, name="olmoe-1b-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab=256, head_dim=16, n_experts=8, top_k=2,
)
