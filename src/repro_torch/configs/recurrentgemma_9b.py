"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn per 3
blocks ((rec,rec,attn)x12 + 2 rec), MQA kv=1, window 2048, lru_width 4096
[arXiv:2402.19427]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="rglru",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256, rope_theta=10_000.0,
    window=2048, lru_width=4096, attn_every=3,
)

SMOKE = dataclasses.replace(
    CONFIG, name="recurrentgemma-9b-smoke",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=256, head_dim=16, window=8, lru_width=64,
)
