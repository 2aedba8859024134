"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small model; the
port's copy of ``repro/configs/smollm_135m.py``.

30L d_model=576 9H (kv=3) head_dim=64 d_ff=1536 vocab=49152, SwiGLU, tied
embeddings, fp32 parameters (about 135 M, 0.54 GB).  Every one-shot
prefill's attention core is the port's ``flash_attention`` kernel under
``use_pallas``.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    vocab=49_152,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    mlp_act="silu",
    tie_embeddings=True,
    attn_tp=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=48, vocab=256, n_heads=3, n_kv_heads=1,
        head_dim=16, d_ff=96,
    )
