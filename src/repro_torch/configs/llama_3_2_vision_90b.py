"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-90B-Vision] — VLM backbone;
the port's copy of ``repro/configs/llama_3_2_vision_90b.py``.

100L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256; gated cross-attention
to vision memory every 5th layer (20 cross blocks).  The vision encoder is a
stub: the cross blocks read precomputed patch embeddings [B, 1601, 7680]
passed as ``memory=``.  About 87.6 B parameters (350.6 GB in fp32).  Every
one-shot prefill's self-attention core is the port's ``flash_attention``
kernel under ``use_pallas``; cross-attention is plain PyTorch, as in the
reference.  Pure full attention ⇒ long_500k skipped.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    vocab=128_256,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    mlp_act="silu",
    rope_theta=500_000.0,
    cross_attn_every=5,
    frontend_dim=7680,
    frontend_tokens=1601,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, vocab=256, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, frontend_dim=48, frontend_tokens=17,
    )
