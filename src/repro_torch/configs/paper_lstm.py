"""paper-lstm — the paper's flagship recurrent use case (§I: LSTMs "have
intrinsic state-space forms") as a ModelConfig; the port's copy of
``repro/configs/paper_lstm.py``.

A stack of LSTM cell blocks (RMSNorm → fused-gate cell → out-proj,
residual), each block one state-space system whose serving state is the O(1)
``(h, c)`` carry.  ``smoke_config`` is the CI-sized variant used by tests;
``gru_config`` swaps the cell.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-lstm",
    family="recurrent",
    n_layers=8,
    d_model=1024,
    vocab=32_000,
    rnn_cell="lstm",
    rnn_hidden=1024,
    d_ff=0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256, rnn_hidden=48,
    )


def gru_config() -> ModelConfig:
    return dataclasses.replace(CONFIG, name="paper-gru", rnn_cell="gru")
