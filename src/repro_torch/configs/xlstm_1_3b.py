"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (1 sLSTM per 8) [arXiv:2405.04517].

d_ff=0 per assignment: block-internal projections use mlstm_proj_factor=2.0
(mLSTM) and slstm_ff_factor=4/3 (sLSTM GeGLU)."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_every=8,
    mlstm_proj_factor=2.0, slstm_ff_factor=4.0 / 3.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-1.3b-smoke",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab=256,
    slstm_every=2,
)
