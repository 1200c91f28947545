"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
Mamba:attention 7:1 (attention at offset 4 of each 8-layer Jamba block),
MoE 16 experts top-2 at every other layer, vocab=65536.
[arXiv:2403.19887; hf]"""
from repro_torch.models.config import BlockSpec, MambaCfg, ModelConfig, MoECfg


def _pattern(n_layers):
    specs = []
    for i in range(n_layers):
        mixer = "attn" if i % 8 == 4 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        specs.append(BlockSpec(mixer=mixer, mlp=mlp))
    return tuple(specs)


def config():
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=65536,
        norm="rmsnorm", act="swiglu", rope_theta=10000.0,
        moe=MoECfg(n_experts=16, top_k=2, n_shared=0, d_ff_expert=14336,
                   router_aux_free_bias=False),
        mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
        pattern=_pattern(32),
        subquadratic=True,   # 4 attention layers; SSM state carries the rest
        param_dtype="bfloat16", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=96, capacity_factor=64.0,
                   router_aux_free_bias=False),
        mamba=MambaCfg(d_state=8, d_conv=4, expand=2),
        pattern=_pattern(8), subquadratic=True,
        param_dtype="float32", activation_dtype="float32",
    )
