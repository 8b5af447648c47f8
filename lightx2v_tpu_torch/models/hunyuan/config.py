"""HunyuanVideo MMDiT architecture (counterpart of
``lightx2v_tpu.models.hunyuan.config``): 20 double-stream and 40
single-stream blocks of 24 heads of 128, the Llama hidden states (4096) and
the CLIP-L pooled vector (768) as conditioning, embedded guidance. ``task``
"i2v" adds the token-replace vector (the t = 0 modulation of the first
latent frame's tokens)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class HunyuanArch:
    hidden_size: int = 3072
    heads_num: int = 24
    double_blocks: int = 20
    single_blocks: int = 40
    mlp_hidden_dim: int = 12288
    in_channels: int = 16
    out_channels: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_states_dim: int = 4096   # Llama hidden
    text_states_dim_2: int = 768  # CLIP-L pooled
    rope_dim_list: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 256.0
    guidance_embed: bool = True
    task: str = "t2v"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads_num
