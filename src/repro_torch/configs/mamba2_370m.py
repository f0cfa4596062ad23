"""mamba2-370m [ssm]: 48L d=1024 attention-free, ssm_state=128 —
SSD (state-space duality). d_inner=2048, headdim=64 => 32 ssm heads.
[arXiv:2405.21060]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="mamba2-370m", family="ssm",
    num_layers=48, hidden=1024, heads=0, kv_heads=0,
    ffn=0, vocab=50280, ssm_state=128, ssm_heads=32,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="mamba2-reduced", family="ssm",
        num_layers=2, hidden=128, heads=0, kv_heads=0,
        ffn=0, vocab=128, ssm_state=16, ssm_heads=4,
    )
