"""internvl2-26b [vlm] — InternLM2-20B backbone: 48L d_model=6144 48H
(GQA kv=8) d_ff=16384 vocab=92553; InternViT frontend is a STUB per the
assignment spec (input_specs supply precomputed patch embeddings).
[arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig

# InternViT-6B emits 1024-d patch embeddings (pre pixel-shuffle projector);
# 256 visual tokens per image tile after pixel-shuffle.
PATCH_TOKENS = 256
PATCH_DIM = 3200


def config():
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92553,
        norm="rmsnorm", act="swiglu", rope_theta=1000000.0,
        frontend="patch_stub", frontend_dim=PATCH_DIM,
        frontend_len=PATCH_TOKENS,
        param_dtype="bfloat16", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=128,
        frontend="patch_stub", frontend_dim=48, frontend_len=8,
        param_dtype="float32", activation_dtype="float32",
    )
