"""Architecture configuration (``repro/models/config.py``).

One frozen dataclass covers all six families of the JAX package, field for
field, so a config prints and compares the same in both packages; the port
builds only the dense family so far (``models/model.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attn-free
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention details
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (sums to head_dim//2)
    attn_window: int = 0        # sliding-window size; 0 = full attention
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2-style): one *shared* attention block applied every k layers
    attn_every: int = 0

    # encoder-decoder (whisper-style)
    encoder_layers: int = 0
    encoder_frames: int = 1500

    # modality frontend stub: 'none' | 'audio' | 'vision'
    frontend: str = "none"
    vision_patches: int = 1024  # stub patch-embedding count for VLM inputs

    # attention implementation: 'direct' (materialized S x S scores) or
    # 'chunked' (online-softmax scan over KV chunks; §Perf iteration 3)
    attn_impl: str = "direct"
    # attention weight sharding when heads don't divide the model axis:
    # 'flat' (shard anyway; best for memory-bound) or 'replicate' (no score
    # collectives; best for collective-bound) -- see layers._head_spec
    attn_shard_policy: str = "flat"
    # MoE dispatch groups (0 = one per batch row; §Perf iteration 2)
    moe_groups: int = 0

    # numerics / memory
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    remat: bool = True

    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    # ---- parameter count (used for MODEL_FLOPS = 6 N D in the roofline) -----

    def param_count(self) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.hd()
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        attn = q + kv + o + (self.n_heads * hd + 2 * self.n_kv_heads * hd if self.qkv_bias else 0)
        mlp = 3 * d * ff  # swiglu: gate + up + down
        norms = 2 * d
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * ff + d * self.n_experts  # experts + router
        if self.family == "ssm":
            di, st, nh = self.d_inner(), self.ssm_state, self.ssm_heads()
            in_p = d * (2 * di + 2 * st + nh)
            conv = (di + 2 * st) * self.ssm_conv
            out_p = di * d + di  # out proj + gated norm
            per_layer = in_p + conv + out_p + nh * 2 + d  # A, D, norm
            emb = V * d * (1 if self.tie_embeddings else 2)
            return self.n_layers * per_layer + emb + d
        per_layer = attn + mlp + norms
        if self.family == "hybrid":
            di, st, nh = self.d_inner(), self.ssm_state, self.ssm_heads()
            in_p = d * (2 * di + 2 * st + nh)
            conv = (di + 2 * st) * self.ssm_conv
            per_mamba = in_p + conv + di * d + di + nh * 2 + d
            shared_attn = attn + mlp + norms
            emb = V * d * (1 if self.tie_embeddings else 2)
            return self.n_layers * per_mamba + shared_attn + emb + d
        total = self.n_layers * per_layer
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + 3 * d * ff + norms)
            cross = self.n_layers * (q + kv + o + d)
            total += enc + cross
        emb = V * d * (1 if self.tie_embeddings else 2)
        return total + emb + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: only experts_per_tok experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_total = self.param_count()
        all_experts = self.n_experts * 3 * d * ff * self.n_layers
        active = self.experts_per_tok * 3 * d * ff * self.n_layers
        return dense_total - all_experts + active
