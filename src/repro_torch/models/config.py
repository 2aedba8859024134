"""Model configuration: the port's copy of ``repro/models/config.py``.

The same fields and derived properties as the reference's ``ModelConfig``,
so that one configuration means the same network in both packages.  Only the
recurrent family runs in the port so far, but ``layer_pattern``, ``n_groups``
and ``kv_cache_bytes`` agree with the reference for every family.  The two
dtype properties return ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

BlockKind = Literal[
    "attn",          # self-attention + FFN (dense transformer block)
    "attn_local",    # sliding-window self-attention + FFN
    "moe",           # self-attention + MoE FFN
    "cross",         # cross-attention (to vision/audio memory) + FFN
    "mamba1",        # Mamba-1 selective-scan block
    "mamba2",        # Mamba-2 / SSD block
    "shared_attn",   # Zamba-style shared transformer block (weights reused)
    "recurrent",     # LSTM/GRU cell block (paper's intrinsic state-space NN)
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encoder", "vlm", "recurrent"]
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # gemma3: global layers use a larger base
    partial_rotary: float = 1.0      # fraction of head_dim carrying RoPE
    sliding_window: int = 0          # >0 enables local attention windows
    global_every: int = 0            # gemma3: 1 global layer per N (pattern)
    causal: bool = True              # False for encoder-only (hubert)
    attn_logit_softcap: float = 0.0
    # --- FFN ---
    d_ff: int = 0
    mlp_act: Literal["silu", "gelu", "tanh"] = "silu"
    gated_mlp: bool = True
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group_size: int = 0          # dispatch group tokens (0 = 2048 default)
    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba) ---
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_chunk: int = 0               # 0 = per-impl default (the j knob)
    mamba_headdim: int = 64          # mamba2 only
    dt_rank: int = 0                 # mamba1; 0 = ceil(d_model/16)
    # --- recurrent (LSTM/GRU) ---
    rnn_cell: Literal["lstm", "gru"] = "lstm"
    rnn_hidden: int = 0              # 0 = d_model
    # --- hybrid (zamba2) ---
    attn_block_period: int = 0       # shared attn applied once per N ssm blocks
    shared_attn_lora_rank: int = 0   # per-application LoRA on shared weights
    # --- vlm / audio frontends ---
    cross_attn_every: int = 0        # llama-vision: cross block per N
    frontend_dim: int = 0            # precomputed patch/frame embedding dim
    frontend_tokens: int = 0         # number of vision/audio memory tokens
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "float32"           # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True               # activation checkpointing (training)
    scan_unroll: int = 1             # the paper's j knob
    use_pallas: bool = False         # hand-written kernels (CUDA in the port)
    use_codegen: bool = False        # generated stage kernels (codegen)
    quant_gate_bits: int = 0         # int8 gate MACC in the generated kernel
    sequence_parallel: bool = False
    attn_tp: bool = True
    pure_dp: bool = False
    # blocks appended AFTER the group stack when n_layers % period != 0
    tail_pattern: tuple = ()

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def n_mamba_heads(self) -> int:
        return self.d_inner // self.mamba_headdim

    @property
    def rnn_hidden_actual(self) -> int:
        return self.rnn_hidden or self.d_model

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def layer_pattern(self) -> tuple[str, ...]:
        """The repeating block pattern: heterogeneous stacks become a uniform
        stack of *groups* of ``period`` blocks."""
        if self.family == "ssm":
            return ("mamba1",)
        if self.family == "recurrent":
            return ("recurrent",)
        if self.family == "hybrid":
            return ("mamba2",) * self.attn_block_period + ("shared_attn",)
        if self.family == "moe":
            return ("moe",)
        if self.family == "vlm" and self.cross_attn_every:
            return ("attn",) * (self.cross_attn_every - 1) + ("cross",)
        if self.global_every:
            return ("attn_local",) * (self.global_every) + ("attn",)
        return ("attn",)

    @property
    def n_groups(self) -> int:
        period = len(self.layer_pattern)
        body = self.n_layers - len(self.tail_pattern)
        if body % period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} minus tail "
                f"{len(self.tail_pattern)} not divisible by pattern period "
                f"{period} ({self.layer_pattern})"
            )
        return body // period

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    def kv_cache_bytes(self, batch: int, seq: int) -> int:
        """Serving-cache footprint (bf16 KV, f32 recurrent/SSM state)."""
        bpe = 2
        total = 0
        for kind in self.layer_pattern:
            if kind in ("attn", "moe", "cross"):
                if self.use_mla:
                    total += batch * seq * (self.kv_lora_rank + self.qk_rope_head_dim) * bpe
                else:
                    total += 2 * batch * seq * self.n_kv_heads * self.head_dim * bpe
            elif kind == "attn_local":
                s = min(seq, self.sliding_window)
                total += 2 * batch * s * self.n_kv_heads * self.head_dim * bpe
            elif kind == "shared_attn":
                total += 2 * batch * seq * self.n_kv_heads * self.head_dim * bpe
            elif kind == "recurrent":
                # f32 (h, c) carry — O(1) in seq; the cheapest serving state
                n_regs = 2 if self.rnn_cell == "lstm" else 1
                total += batch * n_regs * self.rnn_hidden_actual * 4
            elif kind in ("mamba1", "mamba2"):
                if kind == "mamba1":
                    total += batch * self.d_inner * (self.ssm_state + self.d_conv - 1) * 4
                else:
                    total += batch * (
                        self.n_mamba_heads * self.mamba_headdim * self.ssm_state
                        + (self.d_inner + 2 * self.ssm_state) * (self.d_conv - 1)
                    ) * 4
        return total * self.n_groups


__all__ = ["BlockKind", "ModelConfig"]
