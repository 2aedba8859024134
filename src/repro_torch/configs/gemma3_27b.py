"""gemma3-27b [hf:google/gemma-3] — dense, 5:1 local:global attention; the
port's copy of ``repro/configs/gemma3_27b.py``.

62L d_model=5376 32H (kv=16) head_dim=128 d_ff=21504 vocab=262144,
qk-norm, GELU-tanh MLP, tied embeddings, sliding window 1024 on local
layers, RoPE base 10k local / 1M global.  Pattern: 5 local + 1 global per
group (10 groups) + a 2-layer local tail (62 = 6·10 + 2).  A local layer's
decode cache is a ring of ``min(max_seq, 1024)`` positions.  About 27 B
parameters (108 GB in fp32): it does not fit one card in fp32 at full
depth.  Every one-shot prefill's attention core is the port's
``flash_attention`` kernel under ``use_pallas``, with the window on the
local layers.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    vocab=262_144,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    qk_norm=True,
    sliding_window=1024,
    global_every=5,           # pattern: 5 local + 1 global
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    d_ff=21_504,
    mlp_act="gelu",
    tail_pattern=("attn_local", "attn_local"),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, vocab=256, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, sliding_window=16,
    )
