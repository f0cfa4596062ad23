"""Small cells for the CPU: the real traffic files at small sizes, and
small dense, sliding-window and mixture-of-experts configurations."""
import copy

from portbench.harness.spec import BENCH, Cell, Shape, load_json

DENSE = {"name": "dense-small", "num_hidden_layers": 2, "hidden_size": 64,
         "intermediate_size": 96, "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6}
WIDER = dict(DENSE, name="dense-wider", num_hidden_layers=8, hidden_size=256,
             intermediate_size=704, num_attention_heads=8, vocab_size=4096)
# a head size of its own (derived: 64 / 4 = 16) and a 12-key window on every
# layer: shorter than the train cell's S=32 and the serve cell's 24-token
# prompt, whose KV cache is then a 12-slot ring
WINDOWED = dict(DENSE, name="dense-windowed", head_dim=24, sliding_window=12)
# granite's shape at a small size: 8 experts of width 32, 2 a token, a tied
# head; B=4 x S=32 gives each expert 40 slots for its 32 assignments on average
MOE = dict(DENSE, name="moe-small", intermediate_size=32, num_local_experts=8,
           num_experts_per_tok=2, tie_word_embeddings=True)


def cell(config: dict, mix: str, checks: str, dtype: str = "float32", **sizes) -> Cell:
    """A cell of ``config`` under the traffic file ``mix`` cut to ``sizes``,
    held to the limits of the real cell ``checks``, computing in ``dtype``."""
    m = load_json(BENCH / "traffic" / f"{mix}.json")
    m.update(sizes, compute_dtype=dtype)
    return Cell("small", 1, copy.deepcopy(config), Shape.from_config(config), m,
                load_json(BENCH / "checks" / f"{checks}.json"), [], [])


def train_cell(config=DENSE, checks="train.yi-6b.s2048", mix="train-b4-s2048", **kw):
    return cell(config, mix, checks, **(dict(batch=4, seq=32, pool=6) | kw))


def moe_train_cell(**kw):
    return train_cell(MOE, "train.granite-moe-3b-a800m.s2048", "train-b8-s2048", **kw)


def serve_cell(config=DENSE, **kw):
    return cell(config, "serve-doc4k", "serve.yi-6b.doc4k",
                **(dict(batch=3, prompt_len=24, new_tokens=5, max_len=29, check_requests=4) | kw))
