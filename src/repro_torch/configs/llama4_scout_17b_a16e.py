"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192,
vocab 202048, 16 experts top-1, early fusion (text stream here; the fused
modality tokens arrive pre-embedded like every frontend stub).
[hf:meta-llama/Llama-4-Scout-17B-16E]

In the port for its reduced config, the only one with a shared expert (the
CPU tests hold ``moe.shared_wi`` / ``moe.shared_wo`` against the JAX package
with it). The full config, 107.8e9 parameters (216 GB in bf16), does not fit
one 80 GB card: its params need at least three cards, and the port does not
shard the moe family yet (ROADMAP)."""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, hidden=5120, heads=40, kv_heads=8,
    ffn=8192, vocab=202048, num_experts=16, top_k=1, moe_ffn=8192,
    shared_expert=True,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="llama4-scout-reduced", family="moe",
        num_layers=2, hidden=128, heads=8, kv_heads=2,
        ffn=256, vocab=128, num_experts=4, top_k=1, moe_ffn=256,
        shared_expert=True,
    )
