"""zamba2-1.2b [arXiv:2411.15242; hf] — hybrid Mamba-2 + one SHARED
attention block; the port's copy of ``repro/configs/zamba2_1_2b.py``.

38 blocks: 32 Mamba-2 (SSD) + 6 applications of ONE shared transformer
block (the paper's resource sharing taken literally: the same weights are
time-multiplexed at 6 depths, told apart by per-application LoRA of rank
128).  Pattern: (5 × mamba2 + shared_attn) × 6 groups + a 2-block mamba2
tail = 38.  d_model 2048, d_inner 4096 (64 heads × 64), ssm_state 64,
d_conv 4; shared block: 32 heads MHA (kv 32) at hd 64, d_ff 8192 gated
GELU-tanh MLP; vocab 32 000, untied.  1 026 412 544 parameters, 4.11 GB
in fp32: the whole model fits one card.  Every one-shot prefill's six
shared-attention cores are the port's ``flash_attention`` kernel under
``use_pallas``; the SSD scan is plain PyTorch (the reference has no
kernel for it).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    vocab=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    mlp_act="gelu",
    ssm_state=64,
    d_conv=4,
    expand=2,
    mamba_headdim=64,
    attn_block_period=5,
    shared_attn_lora_rank=128,
    tail_pattern=("mamba2", "mamba2"),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, vocab=256, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, ssm_state=16, mamba_headdim=32,
        attn_block_period=2, shared_attn_lora_rank=8,
        tail_pattern=("mamba2", "mamba2"),
    )
