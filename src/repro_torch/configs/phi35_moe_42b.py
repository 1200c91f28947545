"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400,
16 experts top-2, vocab=32064. [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.models.config import ModelConfig, MoECfg


def config():
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064,
        norm="layernorm", act="swiglu", rope_theta=10000.0,
        moe=MoECfg(n_experts=16, top_k=2, n_shared=0, d_ff_expert=6400,
                   capacity_factor=1.25, router_aux_free_bias=False),
        param_dtype="bfloat16", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="phi3.5-moe-smoke", family="moe",
        n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
        norm="layernorm",
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=96, capacity_factor=64.0,
                   router_aux_free_bias=False),
        param_dtype="float32", activation_dtype="float32",
    )
