"""qwen3-4b [dense] — qk_norm, GQA kv=8, head_dim 128 [hf:Qwen/Qwen3-4B]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, head_dim=128, rope_theta=1_000_000.0,
    qk_norm=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-4b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16,
)
