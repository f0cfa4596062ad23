"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads in every layer; sliding
window attention (1024) gives sub-quadratic long-context decode.
[arXiv:2411.13676]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, hidden=1600, heads=25, kv_heads=5,
    ffn=5504, vocab=32001, ssm_state=16, ssm_heads=50,
    sliding_window=1024,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="hymba-reduced", family="hybrid",
        num_layers=2, hidden=128, heads=4, kv_heads=2,
        ffn=256, vocab=128, ssm_state=8, ssm_heads=4,
        sliding_window=32,
    )
