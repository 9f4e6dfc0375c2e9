"""Architecture config schema (the port's own copy of the subset it runs).

``ArchConfig`` keeps the field names and defaults of the reference schema
for every field the dense and MoE transformers read, so a config written
for one package reads the same in the other, the hybrid family's SSM
fields (zamba2-7b's Mamba2 mixer and its shared attention block) and
the RWKV6 fields (rwkv6-1.6b's time-mix head width, WKV chunk and LoRA
widths) and the frontend fields of the cross-attention families (the
VLM's ``cross_attn_every`` / ``n_img_tokens``, the encoder-decoder's
``n_enc_layers`` / ``n_src_frames``, both families' ``d_frontend``)
included. Of the execution knobs the port keeps the two training reads, ``remat``
(recompute each layer's activations in the backward pass) and
``grad_accum`` (microbatches per train step), and the MoE block's two:
``moe_group_size`` (dispatch-group tokens) and ``moe_parallelism``, where
on one device "tp" and "local" run the same code and "ep" (experts
sharded over devices) raises (ROADMAP A5, item 2).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "vlm", "audio", "hybrid"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int = 0
    d_head: int = 0                    # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    mlp: Literal["gated", "plain"] = "gated"
    act: str = "silu"
    qkv_bias: bool = False
    rope_pct: float = 1.0              # fraction of head dim rotated
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: int = 0            # 0 = full attention; >0 = SWA (mixtral)
    # --- MoE (family "moe") ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # --- SSM (mamba2 / zamba hybrid) ---
    ssm_state: int = 0                 # d_state
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 64                # SSD chunk length (matmul form)
    shared_attn_every: int = 0         # zamba: shared attn block cadence
    # --- rwkv6 ---
    rwkv_head_dim: int = 0             # >0 selects the rwkv6 time-mix family
    rwkv_chunk: int = 16               # chunked-WKV chunk length
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32
    # --- vlm / audio frontends (stubs: precomputed embeddings) ---
    cross_attn_every: int = 0          # vlm: every k-th layer is cross-attn
    n_img_tokens: int = 1600           # precomputed patch embeddings
    d_frontend: int = 0                # frontend embedding dim (0 -> d_model)
    # --- enc-dec (seamless) ---
    n_enc_layers: int = 0              # >0 selects encoder-decoder
    n_src_frames: int = 1024           # precomputed audio-frame embeddings
    remat: bool = True                 # per-layer activation checkpointing
    grad_accum: int = 1                # microbatches per step (train memory)
    dtype: str = "bfloat16"            # compute/param dtype ("float32" on CPU tests)
    moe_parallelism: Literal["tp", "ep", "local"] = "tp"
    moe_group_size: int = 0            # dispatch-group tokens (0 = full seq)

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_rwkv(self) -> bool:
        return self.rwkv_head_dim > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        from repro_torch.models import param_count

        return param_count(self)

    def n_active_params(self) -> int:
        """Active-per-token parameters (MoE: top_k of n_experts)."""
        from repro_torch.models import param_count

        return param_count(self, active_only=True)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
