"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
(``repro/configs/``).

The port has every architecture of the JAX package's registry, each config
equal to the JAX package's field for field.  qwen2-0.5b keeps its module
(``qwen2_0_5b.py``); the later archs are ``config()`` / ``smoke_config()``
pairs below, one section per JAX config module, since the port adds no
file under ``src/``.  Smoke variants are reduced (2 layers, d_model <= 256,
<= 4 experts) same-family configs for CPU tests.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

from repro_torch.models.config import ModelConfig


# -- minitron-8b (``repro/configs/minitron_8b.py``) ---------------------------
# Width-pruned Nemotron-4 [arXiv:2407.14679]: dense, 32L x d4096, 32 query
# heads with GQA kv=8, SwiGLU ff=16384, 256k vocabulary.

def _minitron_8b() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=16384, vocab=256000, head_dim=128,
        rope_theta=1e4, attn_window=0,
    )


def _minitron_8b_smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=1024, head_dim=64,
    )


# -- granite-moe-3b-a800m (``repro/configs/granite_moe_3b_a800m.py``) ---------
# Fine-grained MoE: 40 experts top-8, per-expert ff=512; 24 heads do not
# divide the 16-way model axis, so attention weights replicate.

def _granite_moe() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155, head_dim=64,
        n_experts=40, experts_per_tok=8,
        attn_shard_policy="replicate",
    )


def _granite_moe_smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=1024, head_dim=64,
        n_experts=4, experts_per_tok=2,
    )


# -- mamba2-130m (``repro/configs/mamba2_130m.py``) ---------------------------
# SSD [arXiv:2405.21060]: attention-free, 24 SSD blocks, d_model=768
# (d_inner=1536, 24 heads of 64), state=128, tied embeddings, vocab 50280.

def _mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        ssm_chunk=128,
        tie_embeddings=True,
    )


def _mamba2_130m_smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=1024,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_conv=4,
        ssm_chunk=32,
        tie_embeddings=True,
    )


# -- phi3-medium-14b (``repro/configs/phi3_medium_14b.py``) -------------------
# [arXiv:2404.14219]: dense, 40L x d5120, 40 heads GQA kv=10, ff=17920.

def _phi3_medium() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        d_ff=17920, vocab=100352, head_dim=128,
    )


def _phi3_medium_smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=1024, head_dim=64,
    )


# -- dbrx-132b (``repro/configs/dbrx_132b.py``) -------------------------------
# [hf:databricks/dbrx-base]: MoE, 16 experts top-4, 40L x d6144, 48 heads
# GQA kv=8, per-expert ff=10752, vocab 100352.

def _dbrx() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352, head_dim=128,
        n_experts=16, experts_per_tok=4,
    )


def _dbrx_smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=1024, head_dim=64,
        n_experts=4, experts_per_tok=2,
    )


# -- minicpm-2b (``repro/configs/minicpm_2b.py``) -----------------------------
# [arXiv:2404.06395]: llama-like dense, trained with the WSD schedule (the
# driver's ``--schedule auto``); 40L x d2304, 36 heads MHA, ff=5760, vocab
# 122753, tied embeddings.

def _minicpm() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab=122753, head_dim=64,
        tie_embeddings=True,
    )


def _minicpm_smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=1024, head_dim=64,
        tie_embeddings=True,
    )


# -- qwen2-vl-2b (``repro/configs/qwen2_vl_2b.py``) ---------------------------
# [arXiv:2409.12191]: M-RoPE VLM, language decoder only (the vision tower is
# a stub: batches carry precomputed patch embeddings before the text);
# 28L x d1536, 12 heads GQA kv=2, ff=8960, vocab 151936, M-RoPE sections
# (16, 24, 24) over head_dim/2 = 64 frequency channels.

def _qwen2_vl() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, head_dim=128,
        qkv_bias=True, mrope_sections=(16, 24, 24),
        frontend="vision", vision_patches=1024,
    )


def _qwen2_vl_smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=1024, head_dim=64,
        qkv_bias=True, mrope_sections=(8, 12, 12),
        frontend="vision", vision_patches=16,
    )


# -- whisper-medium (``repro/configs/whisper_medium.py``) ---------------------
# [arXiv:2212.04356]: encoder-decoder, 24 + 24 layers, d1024, 16 heads MHA,
# ff=4096, vocab 51865; the audio frontend is a stub (batches carry
# (B, 1500, d) frame embeddings); SwiGLU and RMSNorm, sinusoidal positions
# on both sides, no RoPE.

def _whisper_medium() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865, head_dim=64,
        encoder_layers=24, encoder_frames=1500,
        rope_theta=0.0,  # sinusoidal absolute positions, no RoPE
        frontend="audio",
    )


def _whisper_medium_smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=1024, head_dim=32,
        encoder_layers=2, encoder_frames=64,
        rope_theta=0.0, frontend="audio",
    )


# -- zamba2-7b (``repro/configs/zamba2_7b.py``) -------------------------------
# [arXiv:2411.15242]: hybrid, 81 Mamba-2 layers (d3584, d_inner 7168, 112
# ssm heads of 64, state 64) and one shared attention+MLP block (32-head
# MHA, head_dim 112, SwiGLU ff=14336) after every 6th layer; vocab 32000.

def _zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000, head_dim=112,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        ssm_chunk=128,
        attn_every=6,
    )


def _zamba2_7b_smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=1024, head_dim=32,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_conv=4,
        ssm_chunk=32,
        attn_every=2,
    )


#: arch -> (config, smoke_config) of the archs without a module of their own
_PAIRS: Dict[str, Tuple[Callable[[], ModelConfig],
                        Callable[[], ModelConfig]]] = {
    "minitron-8b": (_minitron_8b, _minitron_8b_smoke),
    "granite-moe-3b-a800m": (_granite_moe, _granite_moe_smoke),
    "mamba2-130m": (_mamba2_130m, _mamba2_130m_smoke),
    "phi3-medium-14b": (_phi3_medium, _phi3_medium_smoke),
    "dbrx-132b": (_dbrx, _dbrx_smoke),
    "minicpm-2b": (_minicpm, _minicpm_smoke),
    "qwen2-vl-2b": (_qwen2_vl, _qwen2_vl_smoke),
    "whisper-medium": (_whisper_medium, _whisper_medium_smoke),
    "zamba2-7b": (_zamba2_7b, _zamba2_7b_smoke),
}

#: the ported archs in the JAX registry's order; qwen2 has its own module
ARCHS = ["minitron-8b", "granite-moe-3b-a800m", "mamba2-130m",
         "phi3-medium-14b", "qwen2-vl-2b", "dbrx-132b", "whisper-medium",
         "minicpm-2b", "qwen2-0.5b", "zamba2-7b"]
#: the JAX registry's archs the port does not have (none since the hybrid,
#: encdec and vlm families)
NOT_PORTED: List[str] = []


def _pair(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; ported: {ARCHS}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    if name in _PAIRS:
        return _PAIRS[name]
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.config, mod.smoke_config


def get_config(name: str) -> ModelConfig:
    return _pair(name)[0]()


def get_smoke_config(name: str) -> ModelConfig:
    return _pair(name)[1]()


def list_archs() -> List[str]:
    return list(ARCHS)


def known_archs() -> List[str]:
    """The JAX package's arch ids: the ported ones and the rest (what an
    experiment spec may name)."""
    return ARCHS + NOT_PORTED
