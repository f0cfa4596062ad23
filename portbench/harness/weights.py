"""Weights made from the run's seed, by the benchmark, on the device.

The layout is the one the port's LM takes (each per-layer leaf stacked on a
leading L axis): ``embed`` (V, d), ``lm_head`` (d, V) unless tied,
``final_norm`` (d,), and under ``layers``: ``ln1``, ``ln2`` (L, d),
``attn.wqkv`` (L, d, (H + 2 Hkv) D), ``attn.wo`` (L, H D, d), and
``mlp.wi`` (L, d, 2F) and ``mlp.wo`` (L, F, d) for a dense model, or, with E
experts of width F, ``moe.router`` (L, d, E), ``moe.wi`` (L, E, d, 2F) and
``moe.wo`` (L, E, F, d) in their place.

Each leaf has a generator of its own, seeded from the run's seed and the
leaf's index, so that one leaf can be made again alone (the check of a train
run compares each leaf with its start after the program has updated it in
place). One ``randn`` call a leaf, drawn straight in the type it is used in.

Drawn alone, a query and a key are independent, so the attention scores are
about N(0, 1) and spread over every key: at 4,080 keys no key carries more
than about 0.5%, and the attention output is the mean of the values, which a
decode step that lost its key, its cache write or its attention moves too
little to see. A mix that sets ``query_key_noise`` draws each query head's
projection as its kv head's key projection plus that factor times its own
draw. A token's score against its own key is then about sqrt(head_dim), and
its attention rests mostly on itself, as a trained model's sharp heads do.
A train mix leaves them independent: its check reads the backward and the
optimizer, and its faults show there without it.
"""
from __future__ import annotations

import torch

from portbench.harness.spec import Shape


def leaf_specs(s: Shape) -> list[tuple[str, tuple[int, ...], float, bool]]:
    """(dotted path, shape, scale, is_norm) of every leaf, in a fixed order.
    Products are N(0, scale^2): 1 / sqrt(fan-in) into the residual stream's
    width, and that over sqrt(2 L) out of a sub-layer; norm weights are
    1 + 0.1 N(0, 1), so a norm that dropped its weight would show."""
    d, D, L, F = s.hidden, s.head_dim, s.layers, s.ffn
    fan = d ** -0.5
    out = fan / (2.0 * L) ** 0.5
    specs = [
        ("embed", (s.vocab, d), fan, False),
        ("final_norm", (d,), 0.1, True),
        ("layers.ln1", (L, d), 0.1, True),
        ("layers.ln2", (L, d), 0.1, True),
        ("layers.attn.wqkv", (L, d, (s.heads + 2 * s.kv_heads) * D), fan, False),
        ("layers.attn.wo", (L, s.heads * D, d), out, False),
    ]
    if s.experts:  # in the MLP's place; a dense model's leaves keep their indices
        E, F = s.experts, s.expert_ffn
        specs += [
            ("layers.moe.router", (L, d, E), fan, False),
            ("layers.moe.wi", (L, E, d, 2 * F), fan, False),
            ("layers.moe.wo", (L, E, F, d), F ** -0.5 / (2.0 * L) ** 0.5, False),
        ]
    else:
        specs += [
            ("layers.mlp.wi", (L, d, 2 * F), fan, False),
            ("layers.mlp.wo", (L, F, d), F ** -0.5 / (2.0 * L) ** 0.5, False),
        ]
    if not s.tie:
        specs.append(("lm_head", (d, s.vocab), fan, False))
    return specs


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7_919 * (index + 1)) % (2 ** 63 - 1)


def _queries_near_keys(s: Shape, wqkv: torch.Tensor, noise: float) -> None:
    """Each query head's columns of ``wqkv`` made, in place, its kv head's
    key columns plus ``noise`` times their own draw (query head h reads kv
    head h // (heads / kv_heads))."""
    L, d, _ = wqkv.shape
    H, Hkv, D = s.heads, s.kv_heads, s.head_dim
    q = wqkv[..., :H * D].view(L, d, Hkv, H // Hkv, D)
    k = wqkv[..., H * D:(H + Hkv) * D].view(L, d, Hkv, 1, D)
    q.mul_(noise).add_(k)


def make_leaf(s: Shape, seed: int, path: str, dtype: torch.dtype, device,
              query_key_noise: float | None = None) -> torch.Tensor:
    for i, (p, shape, scale, is_norm) in enumerate(leaf_specs(s)):
        if p == path:
            g = torch.Generator(device=device).manual_seed(leaf_seed(seed, i))
            x = torch.randn(shape, generator=g, dtype=dtype, device=device).mul_(scale)
            if p == "layers.attn.wqkv" and query_key_noise is not None:
                _queries_near_keys(s, x, query_key_noise)
            return x.add_(1.0) if is_norm else x
    raise KeyError(path)


def make_weights(s: Shape, seed: int, dtype: torch.dtype, device,
                 query_key_noise: float | None = None) -> dict:
    """The nested dict of every leaf in ``dtype``."""
    tree: dict = {}
    for path, *_ in leaf_specs(s):
        node = tree
        *parents, last = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = make_leaf(s, seed, path, dtype, device, query_key_noise)
    return tree


def widened(tree: dict) -> dict:
    """The tree with every leaf in float32."""
    return {k: widened(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, leaf) pairs in ``leaf_specs`` order for a tree made here."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out += leaves(v, path + ".") if isinstance(v, dict) else [(path, v)]
    return out

