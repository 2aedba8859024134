"""phi4-mini-3.8b [arXiv:2412.08905; hf] — dense, partial RoPE, SwiGLU GQA;
the port's copy of ``repro/configs/phi4_mini_3_8b.py``.

32L d_model=3072 24H (kv=8) head_dim=128 d_ff=8192 vocab=200064, partial
rotary 0.75, tied embeddings, fp32 parameters (about 3.8 B, 15.3 GB).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    vocab=200_064,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    mlp_act="silu",
    partial_rotary=0.75,
    tie_embeddings=True,
    attn_tp=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256, n_heads=6, n_kv_heads=2,
        head_dim=16, d_ff=128,
    )
