"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MoE with MLA; the port's
copy of ``repro/configs/deepseek_v2_lite_16b.py``.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; MLA kv_lora=512
(the cache holds the 512-wide latent and a 64-wide rope key per token and
layer); 2 shared + 64 routed experts, top-6 (the HF V2-Lite layout: 64
routed, not full V2's 160).  16.21 B parameters, 64.8 GB in fp32.  MLA has
no kernel in either package: its attention is plain einsums, so a prefill
makes no ``flash_attention`` call.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    vocab=102_400,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,            # nominal (MLA path does not use it)
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    mlp_act="silu",
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256, n_heads=4, n_kv_heads=4,
        head_dim=24, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=48,
    )
