"""qwen3-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk_norm. [hf:Qwen/Qwen3-8B]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="qwen3-8b", family="dense",
    num_layers=36, hidden=4096, heads=32, kv_heads=8,
    ffn=12288, vocab=151936, qk_norm=True,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="qwen3-8b-reduced", family="dense",
        num_layers=2, hidden=128, heads=8, kv_heads=2,
        ffn=320, vocab=128, qk_norm=True,
    )
