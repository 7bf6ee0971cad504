"""glm4-9b [dense] — RoPE, GQA kv=2 [hf:THUDM/glm-4-9b]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, head_dim=128, rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="glm4-9b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16,
)
