"""Config dataclasses shared by every architecture.

Every assigned architecture gets a module in this package defining
``CONFIG`` (full production config, exact dims from the assignment) and
``SMOKE`` (reduced same-family config for CPU tests).

A copy of the JAX package's ``configs/base.py``; ``ModelConfig.dtype`` is a
``torch.dtype`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_free: bool = False  # DeepSeek-V3 aux-loss-free bias balancing
    router_noise: float = 0.0
    # group-limited selection (DeepSeek-V3's noaux_tc): experts in n_group
    # equal groups, a token's top_k taken inside its topk_group best groups
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0   # scales the normalised weights
    # expert parallelism: this chip holds experts [expert_rank * held_experts,
    # (expert_rank + 1) * held_experts) of n_experts; 0 holds every expert
    # in the capacity-buffer layer.  With held experts the layer routes over
    # all n_experts, drops no pair, and adds only its own experts' part
    held_experts: int = 0
    expert_rank: int = 0
    dense_prefix: int = 0         # leading dense layers (at least one stays MoE)


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN RoPE scaling (DeepSeek-V3's ``rope_scaling``): ramped inverse
    frequencies between ``beta_fast`` and ``beta_slow`` rotations over the
    original context, and the softmax scale times mscale(factor,
    mscale_all_dim)²."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_scaling: YaRNConfig | None = None   # on the rope halves


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (Hymba heads) / RWKV6 head geometry."""

    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64            # RWKV6 head size


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: input_specs() provides precomputed embeddings."""

    kind: str                     # "audio" | "vision"
    n_tokens: int                 # frames / patches per example
    feat_dim: int                 # raw embedding dim fed to the projector


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None     # default d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "swiglu"           # swiglu | gelu
    rope_theta: float = 1e4
    rope: bool = True
    max_seq_len: int = 131072
    tie_embeddings: bool = False
    residual_scale: float = 1.0   # MiniCPM depth-scaled residuals
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    window: int | None = None     # sliding-window size (hybrid/window layers)
    global_layers: tuple[int, ...] = ()   # layers with full attention (hymba)
    n_dec_layers: int = 0         # encoder-decoder: decoder depth
    mtp_heads: int = 0            # DeepSeek multi-token-prediction heads
    frontend: FrontendConfig | None = None
    meta_tokens: int = 0          # Hymba learnable prefix tokens
    dtype: Any = torch.bfloat16
    # source citation from the assignment table
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (per DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":  # rwkv6
            h = d // (self.ssm.head_dim if self.ssm else 64)
            per_layer = d * d * 4 + d * self.d_ff * 2 + d * 32 * 5 * 2 + h * 64
        else:
            hd = self.head_dim
            if self.mla is not None:
                m = self.mla
                per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                per_layer += self.n_heads * m.v_head_dim * d
            else:
                per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                per_layer += self.n_heads * hd * d
            if self.moe is not None:
                e = self.moe
                per_layer += d * e.n_experts  # router
                per_layer += (e.n_experts + e.n_shared) * 3 * d * e.d_expert
            else:
                mult = 3 if self.act == "swiglu" else 2
                per_layer += mult * d * self.d_ff
            if self.family == "hybrid" and self.ssm is not None:
                di = self.ssm.expand * d
                per_layer += d * 2 * di + di * self.ssm.state_dim * 2 + di * d
        total = emb + (L + self.n_dec_layers) * per_layer
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        d, L = self.d_model, self.n_layers
        full_expert = e.n_experts * 3 * d * e.d_expert
        act_expert = (e.top_k + e.n_shared) * 3 * d * e.d_expert
        return int(self.n_params() - L * full_expert + L * act_expert
                   - (L * e.n_shared * 3 * d * e.d_expert))


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (arch × shape) dry-run cell."""

    shape_id: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    step: str                     # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-skip). DESIGN.md §5 skip policy."""
    if cell.shape_id == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 512k dense-KV decode out of regime"
    return True, ""


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Distribution strategy knobs (launcher-level)."""

    fsdp: bool = True                # shard params/opt over data axis (ZeRO-3)
    tensor_parallel: bool = True     # Megatron TP over model axis
    expert_parallel: bool = True     # MoE experts over model axis
    expert_2d: bool = False          # experts over data×model (§Perf EP)
    sequence_parallel: bool = True   # shard seq for norms/residual
    pod_axis_role: str = "data"      # "data" | "pipeline"
    remat: str = "block"             # "none" | "block" | "full"
    grad_compression: str = "none"   # "none" | "int8" | "topk"
    collective_matmul: bool = False  # ring all-gather⊗GEMM overlap (§Perf)
    microbatches: int = 1
