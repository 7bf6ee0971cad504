"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, head_dim=128, rope_theta=50_000.0,
    n_experts=64, top_k=6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="moonshot-v1-16b-a3b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab=256, head_dim=16, n_experts=8, top_k=2,
)
