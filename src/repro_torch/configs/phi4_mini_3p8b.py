"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=200064,
        norm="rmsnorm", act="swiglu", rope_theta=10000.0,
        tie_embeddings=True,
        param_dtype="bfloat16", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="phi4-mini-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, d_ff=128, vocab=160,
        tie_embeddings=True,
        param_dtype="float32", activation_dtype="float32",
    )
