"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) d_ff=512/expert,
vocab 49155, 40 experts top-8. [hf:ibm-granite/granite-3.0-3b-a800m-base]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, hidden=1536, heads=24, kv_heads=8,
    ffn=512, vocab=49155, num_experts=40, top_k=8, moe_ffn=512,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="granite-moe-reduced", family="moe",
        num_layers=2, hidden=96, heads=6, kv_heads=2,
        ffn=64, vocab=128, num_experts=8, top_k=2, moe_ffn=64,
    )
