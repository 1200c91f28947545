"""deepseek-v3-671b [moe] — 61L d_model=7168 128H MLA d_ff(dense)=18432,
MoE 256 routed (d_ff_expert=2048) top-8 + 1 shared, first 3 layers dense,
vocab=129280, MTP. [arXiv:2412.19437; hf]"""
from repro_torch.models.config import MLACfg, ModelConfig, MoECfg


def config():
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab=129280, d_head=128,
        norm="rmsnorm", act="swiglu", rope_theta=10000.0,
        mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                   nope_head_dim=128, v_head_dim=128),
        moe=MoECfg(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048,
                   capacity_factor=1.25, router_aux_free_bias=True),
        first_k_dense=3, mtp_depth=1,
        param_dtype="bfloat16", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, d_head=16,
        mla=MLACfg(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                   nope_head_dim=16, v_head_dim=16),
        moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                   capacity_factor=64.0),
        first_k_dense=1, mtp_depth=1,
        param_dtype="float32", activation_dtype="float32",
    )
