"""Architecture configuration: the port's own copy of
``repro/models/config.py`` (``ModelConfig``).

Every field of the JAX dataclass is kept, with the same defaults, so a
configuration reads the same in both packages; the dtypes are torch
dtypes.  The single-card port reads the trunk, attention-pattern, numerics
and serving fields.  The MoE, SSM, encoder-decoder, frontend, sharding,
remat and optimizer fields are kept as data and never read;
:func:`repro_torch.models.api.build` refuses configurations that would
need them (another family, experts, an embedding frontend, a non-empty
``sharding_preset``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"     # dense | moe | xlstm | hybrid | encdec | vlm | audio

    # transformer trunk
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int | None = None          # default: d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024
    qkv_bias: bool = False               # qwen1.5 style
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"                    # silu (SwiGLU) | gelu (GeGLU)

    # attention pattern: window per layer; -1 = global.  ``local_ratio``:
    # n local layers then 1 global (gemma3 5:1); 0 = all global;
    # -1 = every layer local (mixtral SWA).
    local_window: int = -1
    local_ratio: int = 0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM / xLSTM / hybrid
    ssm_state: int = 0
    conv_kernel: int = 4
    xlstm_slstm_every: int = 0
    shared_attn_every: int = 0

    # enc-dec
    encoder_layers: int = 0

    # modality frontend: "none" = token ids; "embed" = precomputed embeddings
    frontend: str = "none"

    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    # serving
    attn_chunk: int = 1024               # online-softmax KV chunk for long seq
    dense_attn_max_seq: int = 8192       # below this, plain dense attention
    attn_scores_bf16: bool = False       # sp_serve's chunked route only
    # full-sequence attention through the flash_attention CUDA kernel, with
    # the JAX route's one window for every layer (layers.gqa_attention)
    use_flash_attention: bool = False

    # training (kept as data)
    remat: str = "dots"
    optimizer: str = "adamw"
    shard_opt_over_data: bool = False
    fsdp_params: bool = False
    microbatches: int = 1

    # sharding (kept as data; a mesh has no single-card counterpart)
    sharding_overrides: dict | None = None
    sharding_preset: str = ""
    serve_sharding_preset: str = ""
    moe_impl: str = "gather"

    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def window_for_layer(self, i: int) -> int:
        if self.local_window <= 0:
            return -1
        if self.local_ratio == -1:            # every layer windowed (SWA)
            return self.local_window
        if self.local_ratio <= 0:
            return -1
        # pattern: `local_ratio` local layers, then 1 global
        return self.local_window if (i + 1) % (self.local_ratio + 1) != 0 else -1

    def windows(self) -> list[int]:
        return [self.window_for_layer(i) for i in range(self.num_layers)]

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
