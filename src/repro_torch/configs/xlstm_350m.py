"""xlstm-350m [ssm] — 24 blocks d_model=1024 4H, xLSTM[7:1]
(7 mLSTM : 1 sLSTM per period), no separate FFN (d_ff=0 -> mlp='none'),
vocab=50304. [arXiv:2405.04517]"""
from repro_torch.models.config import BlockSpec, ModelConfig, XLSTMCfg


def _pattern(n_layers, ratio=7):
    specs = []
    for i in range(n_layers):
        mixer = "slstm" if i % (ratio + 1) == ratio else "mlstm"
        specs.append(BlockSpec(mixer=mixer, mlp="none"))
    return tuple(specs)


def config():
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        norm="layernorm", act="gelu",
        xlstm=XLSTMCfg(mlstm_per_slstm=7),
        pattern=_pattern(24), subquadratic=True,
        tie_embeddings=True,
        param_dtype="float32", activation_dtype="bfloat16",
    )


def smoke_config():
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=128,
        norm="layernorm", xlstm=XLSTMCfg(),
        pattern=_pattern(8), subquadratic=True, tie_embeddings=True,
        param_dtype="float32", activation_dtype="float32",
    )
