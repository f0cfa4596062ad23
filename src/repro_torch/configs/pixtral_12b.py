"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8) d_ff=14336 vocab=131072 —
pixtral-ViT frontend is a STUB (input_specs provides 1024 precomputed patch
embeddings prepended to the text stream); backbone = mistral-nemo style.
[hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="pixtral-12b", family="vlm",
    num_layers=40, hidden=5120, heads=32, kv_heads=8,
    ffn=14336, vocab=131072, frontend_stub=True, frontend_seq=1024,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="pixtral-reduced", family="vlm",
        num_layers=2, hidden=128, heads=8, kv_heads=2,
        ffn=320, vocab=128, frontend_stub=True, frontend_seq=8,
    )
