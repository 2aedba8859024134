"""falcon-mamba-7b [arXiv:2410.05355] — pure Mamba-1 SSM, attention-free; the
port's copy of ``repro/configs/falcon_mamba_7b.py``.

64L d_model=4096 d_inner=8192 ssm_state=16 vocab=65024, untied head, fp32
parameters (about 7.3 B, 29 GB).  The network IS a state-space system; its
selective scan is the port's ``ssm_scan`` kernel.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    vocab=65_024,
    ssm_state=16,
    d_conv=4,
    expand=2,
    d_ff=0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256, ssm_state=8,
    )
