"""olmoe-1b-7b [arXiv:2409.02060; hf] — 16L MoE, 64 experts top-8, qk-norm;
the port's copy of ``repro/configs/olmoe_1b_7b.py``.

d_model 2048, 16 heads (MHA) at hd 128 with qk-norm, every layer a ``moe``
block: 64 routed experts of width 1024 (SwiGLU), top-8, no shared expert,
capacity factor 1.25 over groups of up to 2048 tokens; vocab 50 304,
untied.  6.92 B parameters, 27.7 GB in fp32.  Every one-shot prefill's
sixteen attention cores are the port's ``flash_attention`` kernel under
``use_pallas``; the MoE FFN is plain PyTorch (the reference has no kernel
for it).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    vocab=50_304,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    qk_norm=True,
    n_experts=64,
    top_k=8,
    n_shared_experts=0,
    d_ff_expert=1024,
    mlp_act="silu",
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256, n_heads=4, n_kv_heads=4,
        head_dim=16, n_experts=8, top_k=2, d_ff_expert=48,
    )
