"""olmo-1b [dense] — 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304,
non-parametric LN. [arXiv:2402.00838; hf]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304,
        norm="nonparam_ln", act="swiglu", rope_theta=10000.0,
        tie_embeddings=True,
        param_dtype="float32", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="olmo-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab=128,
        norm="nonparam_ln", tie_embeddings=True,
        param_dtype="float32", activation_dtype="float32",
    )
