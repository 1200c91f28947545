"""Model configuration for the architecture zoo: the port's own copy of the
JAX package's ``models/config.py`` (pure dataclasses, field for field).

A config is a declarative description: per-layer *block specs* (attention
variant / SSM variant / MLP variant) grouped into repeat-stacks. The port
applies the layers one by one in that order (``scan_groups`` gives the
reference's grouping, which fixes the order of its stacked parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int = 16
    top_k: int = 2
    n_shared: int = 0          # shared (always-on) experts, DeepSeek-style
    d_ff_expert: int = 0       # expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    router_aux_free_bias: bool = True   # DeepSeek aux-loss-free balancing bias
    dispatch: str = "global"   # 'global' (baseline sort) | 'hierarchical'
                               # (per-DP-shard sort + all-to-all, §Perf)


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    # xLSTM[a:b] -> a mLSTM blocks per sLSTM block
    mlstm_per_slstm: int = 7
    conv_dim: int = 4
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer's recipe."""
    mixer: str = "attn"        # 'attn' | 'mla' | 'mamba' | 'mlstm' | 'slstm'
    mlp: str = "dense"         # 'dense' | 'moe' | 'none'
    cross: bool = False        # add cross-attention (enc-dec decoder)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0            # 0 -> d_model // n_heads
    norm: str = "rmsnorm"      # rmsnorm|layernorm|nonparam_ln
    act: str = "swiglu"        # swiglu|gelu
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    tie_embeddings: bool = False
    attn_logit_soft_cap: float = 0.0
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    # layer pattern: explicit sequence of BlockSpec; if None, homogeneous attn
    pattern: Optional[Tuple[BlockSpec, ...]] = None
    first_k_dense: int = 0     # leading dense layers before MoE (DeepSeek: 3)
    # encoder-decoder
    n_enc_layers: int = 0      # >0 -> enc-dec model (n_layers = decoder layers)
    # modality frontend stub: precomputed embeddings prepended/consumed
    frontend: Optional[str] = None    # 'patch_stub' | 'frame_stub'
    frontend_dim: int = 0      # incoming embedding dim (0 -> d_model)
    frontend_len: int = 0      # number of frontend positions (prefix)
    mtp_depth: int = 0         # DeepSeek multi-token-prediction modules
    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    # §Perf lever: explicitly all-gather each layer's FSDP-sharded weights
    # before use (per scan step), instead of letting GSPMD all-reduce
    # activation partials from contracting-dim-sharded matmuls
    fsdp_gather_weights: bool = False
    # §Perf lever: optimization_barrier after mixer/mlp outputs so XLA can't
    # hoist the norm's f32 upcast above the TP all-reduce (payload stays
    # bf16 -> halves the dominant activation all-reduce bytes)
    tp_bf16_payload: bool = False
    # attention flavour for long-context feasibility bookkeeping
    subquadratic: bool = False  # True for ssm/hybrid (long_500k eligible)

    # ------------------------------------------------------------------ #
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def layer_pattern(self) -> Tuple[BlockSpec, ...]:
        if self.pattern is not None:
            assert len(self.pattern) == self.n_layers
            return self.pattern
        mlp = "moe" if (self.moe and not self.first_k_dense) else "dense"
        mixer = "mla" if self.mla else "attn"
        specs = []
        for i in range(self.n_layers):
            use_moe = self.moe is not None and i >= self.first_k_dense
            specs.append(BlockSpec(mixer=mixer,
                                   mlp="moe" if use_moe else "dense"))
        return tuple(specs)

    def layer_groups(self) -> Sequence[Tuple[BlockSpec, int]]:
        """Adjacent identical specs collapsed into (spec, repeat) stacks —
        scan units. Heterogeneous periodic patterns (Jamba/xLSTM) instead
        collapse into (tuple-of-specs, repeat) super-blocks."""
        pat = self.layer_pattern()
        groups = []
        for s in pat:
            if groups and groups[-1][0] == s:
                groups[-1][1] += 1
            else:
                groups.append([s, 1])
        return [(s, n) for s, n in groups]

    def super_blocks(self) -> Tuple[Tuple[BlockSpec, ...], int]:
        """(period_pattern, n_repeats) if the pattern is periodic with a
        period dividing n_layers, else (full_pattern, 1)."""
        pat = self.layer_pattern()
        n = len(pat)
        for period in range(1, n + 1):
            if n % period == 0 and all(pat[i] == pat[i % period]
                                       for i in range(n)):
                return pat[:period], n // period
        return pat, 1

    def scan_groups(self):
        """Scan decomposition: list of (sub_pattern tuple, n_repeats).
        Periodic models (jamba, xlstm) -> one multi-layer super-block scan;
        otherwise adjacent identical layers collapse into homogeneous scans
        (deepseek: [(mla+dense,)x3, (mla+moe,)x58])."""
        pat, nrep = self.super_blocks()
        if nrep > 1:
            return [(pat, nrep)]
        return [((spec,), n) for spec, n in self.layer_groups()]


# shape cells assigned to every LM arch (system spec)
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Whether a shape cell runs for an arch; reason if skipped
    (DESIGN.md §6: long_500k only for sub-quadratic archs)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full softmax attention at 524288-token context is "
                       "quadratic; config defines no sub-quadratic attention "
                       "(skip per spec; run for ssm/hybrid archs)")
    return True, ""
