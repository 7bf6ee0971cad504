"""deepseek-coder-33b [dense] — llama-arch, GQA kv=8 [arXiv:2401.14196]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, head_dim=128, rope_theta=100_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-coder-33b-smoke",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=8,
)
