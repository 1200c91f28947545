"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304, LayerNorm + partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab=50304,
        norm="layernorm", act="swiglu", rope_theta=10000.0, rotary_pct=0.25,
        param_dtype="float32", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=128,
        norm="layernorm", rotary_pct=0.25,
        param_dtype="float32", activation_dtype="float32",
    )
