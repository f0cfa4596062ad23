"""Model-architecture description (paper Eq. 5-6: parsed model architecture M).

The port's own copy of the JAX package's ``core/arch.py`` (stdlib only): the
port imports nothing of ``repro``. One dataclass describes every family the
framework knows; the executable models in :mod:`repro_torch.models` are built
from the same object.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelArch:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    hidden: int
    heads: int
    kv_heads: int
    ffn: int
    vocab: int
    head_dim: Optional[int] = None  # default hidden // heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_ffn: Optional[int] = None  # expert ffn width (d_ff above is dense-path)
    shared_expert: bool = False
    # SSM (mamba2-style)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid: fraction of per-layer compute in the SSM branch (hymba: parallel heads)
    hybrid_parallel_ssm: bool = False
    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder length (whisper: 1500 frames)
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend_stub: bool = False
    frontend_seq: int = 0  # e.g. ViT patch tokens prepended to text
    # attention flavor for long context
    sliding_window: int = 0  # 0 => full attention

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden // max(self.heads, 1))

    # -- census helpers (used by memory/cost models and roofline) ----------
    @property
    def attn_q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def attn_kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic in sequence length => long_500k shape is runnable."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def layer_params(self) -> dict[str, float]:
        """Parameter counts per decoder layer, split by component."""
        h, ffn = self.hidden, self.ffn
        out: dict[str, float] = {}
        if not self.is_attention_free:
            out["attn"] = h * (self.attn_q_dim + 2 * self.attn_kv_dim) + self.attn_q_dim * h
        if self.family == "moe":
            eff = self.moe_ffn or ffn
            out["moe_experts"] = self.num_experts * 3 * h * eff
            if self.shared_expert:
                out["moe_shared"] = 3 * h * eff
            out["router"] = h * self.num_experts
        elif ffn > 0:
            out["mlp"] = 3 * h * ffn  # gated (SwiGLU-family): up+gate+down
        if self.family in ("ssm", "hybrid"):
            d_inner = self.ssm_expand * h
            nheads = self.ssm_heads or max(d_inner // 64, 1)
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            out["ssm"] = (
                h * (2 * d_inner + 2 * self.ssm_state + nheads)
                + d_inner * h
                + 4 * (d_inner + 2 * self.ssm_state)
                + 2 * nheads
            )
        out["norms"] = 2 * h
        return out

    def params_per_layer(self) -> float:
        return float(sum(self.layer_params().values()))

    def active_params_per_layer(self) -> float:
        """Per-token activated parameters (MoE: top_k experts, not all)."""
        p = dict(self.layer_params())
        if self.family == "moe":
            eff = self.moe_ffn or self.ffn
            p["moe_experts"] = self.top_k * 3 * self.hidden * eff
        return float(sum(p.values()))

    def embedding_params(self) -> float:
        n = self.vocab * self.hidden
        return float(n if self.tie_embeddings else 2 * n)

    def total_params(self) -> float:
        n = self.num_layers * self.params_per_layer() + self.embedding_params()
        n += self.encoder_layers * self.params_per_layer()  # enc-dec: same width
        n += self.hidden  # final norm
        return float(n)

    def total_active_params(self) -> float:
        n = self.num_layers * self.active_params_per_layer() + self.embedding_params()
        n += self.encoder_layers * self.active_params_per_layer()
        n += self.hidden
        return float(n)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")
ASSIGNED_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
