"""qwen2-0.5b [arXiv:2407.10671]: GQA with QKV bias.

24L x d896, 14 heads GQA kv=2, ff=4864, vocab 151936, tied embeddings
(494,032,768 parameters).  The smoke config keeps the family and the
head_dim at 2 layers and d_model 256 for CPU tests."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151936, head_dim=64,
        qkv_bias=True, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=1024, head_dim=64,
        qkv_bias=True, tie_embeddings=True,
    )
