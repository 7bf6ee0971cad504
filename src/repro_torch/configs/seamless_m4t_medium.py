"""seamless-m4t-medium [audio] — enc-dec backbone, audio frontend STUB
(input_specs provides precomputed frame embeddings) [arXiv:2308.11596]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, rope_theta=10_000.0,
    n_enc_layers=12, frontend="audio", frontend_dim=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, name="seamless-m4t-medium-smoke",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16, frontend_dim=32,
)
