"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab=128256,
        norm="rmsnorm", act="swiglu", rope_theta=500000.0,
        param_dtype="bfloat16", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="llama3-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192, vocab=256,
        rope_theta=500000.0,
        param_dtype="float32", activation_dtype="float32",
    )
