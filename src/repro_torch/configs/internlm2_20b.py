"""internlm2-20b [arXiv:2403.17297; hf] — dense GQA transformer; the port's
copy of ``repro/configs/internlm2_20b.py``.

48L d_model=6144 48H (kv=8) head_dim=128 d_ff=16384 vocab=92544, SwiGLU,
untied head, RoPE base 1M, pure full attention.  About 20 B parameters
(80 GB in fp32).  Every one-shot prefill's attention core is the port's
``flash_attention`` kernel under ``use_pallas``.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    vocab=92_544,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    mlp_act="silu",
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256, n_heads=6, n_kv_heads=2,
        head_dim=16, d_ff=128,
    )
