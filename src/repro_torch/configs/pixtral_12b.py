"""pixtral-12b [vlm] — pixtral-ViT frontend STUB + mistral-nemo decoder
backbone [hf:mistralai/Pixtral-12B-2409].

input_specs provides precomputed patch embeddings (1024-d) which occupy the
first n_frontend_tokens positions of the sequence."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128, rope_theta=1_000_000.0,
    frontend="patch", frontend_dim=1024, n_frontend_tokens=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, name="pixtral-12b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, frontend_dim=32, n_frontend_tokens=4,
)
