"""yi-6b [dense]: 32L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA. [arXiv:2403.04652]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="yi-6b", family="dense",
    num_layers=32, hidden=4096, heads=32, kv_heads=4,
    ffn=11008, vocab=64000,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="yi-6b-reduced", family="dense",
        num_layers=2, hidden=128, heads=8, kv_heads=1,
        ffn=320, vocab=128,
    )
