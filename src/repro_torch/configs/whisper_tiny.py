"""whisper-tiny [audio enc-dec]: 4L d=384 6H d_ff=1536 vocab=51865;
conv frontend is a STUB (input_specs provides 1500 precomputed frame
embeddings). [arXiv:2212.04356]"""
from repro_torch.core.arch import ModelArch

ARCH = ModelArch(
    name="whisper-tiny", family="encdec",
    num_layers=4, hidden=384, heads=6, kv_heads=6,
    ffn=1536, vocab=51865,
    encoder_layers=4, encoder_seq=1500, frontend_stub=True,
)


def reduced() -> ModelArch:
    return ModelArch(
        name="whisper-reduced", family="encdec",
        num_layers=2, hidden=96, heads=4, kv_heads=4,
        ffn=192, vocab=128,
        encoder_layers=2, encoder_seq=24, frontend_stub=True,
    )
