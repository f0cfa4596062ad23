"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, no-bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="command-r-35b", family="dense",
    num_layers=40, hidden=8192, heads=64, kv_heads=8,
    ffn=22528, vocab=256000,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="command-r-reduced", family="dense",
        num_layers=2, hidden=128, heads=8, kv_heads=2,
        ffn=320, vocab=256,
    )
