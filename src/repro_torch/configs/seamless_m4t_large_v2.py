"""seamless-m4t-large-v2 [audio] — encoder-decoder transformer backbone:
24 enc + 24 dec layers, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
The speech frontend (w2v-BERT conformer feature extractor) is a STUB per the
assignment spec: input_specs provide precomputed frame embeddings to the
encoder. [arXiv:2308.11596; hf]"""
from repro_torch.models.config import BlockSpec, ModelConfig

FRAME_DIM = 1024
FRAME_LEN = 1024     # pooled speech frames fed to the encoder


def config():
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256206,
        norm="layernorm", act="gelu", rope_theta=10000.0,
        n_enc_layers=24,
        pattern=tuple(BlockSpec(mixer="attn", mlp="dense", cross=True)
                      for _ in range(24)),
        frontend="frame_stub", frontend_dim=FRAME_DIM, frontend_len=FRAME_LEN,
        param_dtype="float32", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="seamless-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=200,
        norm="layernorm", act="gelu", n_enc_layers=2,
        pattern=tuple(BlockSpec(mixer="attn", mlp="dense", cross=True)
                      for _ in range(2)),
        frontend="frame_stub", frontend_dim=32, frontend_len=12,
        param_dtype="float32", activation_dtype="float32",
    )
