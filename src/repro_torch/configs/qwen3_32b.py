"""qwen3-32b [dense]: 64L d=5120 64H (GQA kv=8) d_ff=25600 vocab=151936,
qk_norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="qwen3-32b", family="dense",
    num_layers=64, hidden=5120, heads=64, kv_heads=8,
    ffn=25600, vocab=151936, qk_norm=True,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="qwen3-32b-reduced", family="dense",
        num_layers=2, hidden=128, heads=8, kv_heads=2,
        ffn=320, vocab=128, qk_norm=True,
    )
