"""hubert-xlarge [arXiv:2106.07447] — encoder-only audio transformer; the
port's copy of ``repro/configs/hubert_xlarge.py``.

48L d_model=1280 16H d_ff=5120 vocab=504 (target cluster units), a plain
GELU MLP, non-causal MHA at head_dim 80.  The convolutional waveform
frontend is a stub: the model takes precomputed frame embeddings [B, T, 512]
and owns the linear projection into d_model.  Encoder-only ⇒ no decode
shapes; no RoPE (HuBERT's convolutional positional encoding lives inside the
stubbed frontend).  About 945 M parameters (3.78 GB in fp32).  Every
forward's attention core is the port's ``flash_attention`` kernel, non-causal,
under ``use_pallas``.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    vocab=504,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    gated_mlp=False,
    mlp_act="gelu",
    causal=False,
    partial_rotary=0.0,
    frontend_dim=512,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=32, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, frontend_dim=24,
    )
