"""The plain reference of the LMs the benchmark runs: of the llama
architecture (RMSNorm, rotary embedding, grouped-query causal attention,
under each layer's sliding window where the configuration gives one,
SwiGLU), dense or with a mixture of experts in the MLP's place
(``refs/moe.py``), their next-token loss (with the mixture's load-balancing
term), AdamW with global norm clipping and a warm-up + cosine schedule, and
the full forward that a served token is judged by.

Plain PyTorch in float32 with TF32 off, from the sizes of a ``Shape`` and a
dict of weights the benchmark made from the seed. It imports nothing of the
program. ``prec="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with a scale per tensor (the backward passes through the
rounding), the step that a port to fp8 products would take.

Departures from the published models follow the configuration files: the
rotary base and the norm epsilon as run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.refs import moe

FP8_MAX = 448.0  # largest float8 e4m3 value


def exact() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def _ops(prec: str):
    if prec == "float32":
        return lambda x: x
    if prec == "fp8":
        return _fp8
    raise ValueError(prec)


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """Rotate-half rotary embedding of x (B, H, S, D) at ``positions`` (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, scale: float, q_ops, window: int = 0, block: int = 512):
    """Causal GQA attention, q (B, H, S, D) and k, v (B, Hkv, S, D), the
    queries in blocks of ``block`` rows, each against the keys it sees:
    query i sees the keys i - ``window`` < j <= i, or every j <= i where
    ``window`` is 0."""
    B, H, S, D = q.shape
    g = H // k.shape[1]
    k, v = q_ops(k), q_ops(v)
    outs = []
    for a in range(0, S, block):
        b = min(a + block, S)
        lo = max(a - window + 1, 0) if window else 0
        qb = q_ops(q[:, :, a:b]).reshape(B, k.shape[1], g, b - a, D)
        s = torch.einsum("bhgsd,bhtd->bhgst", qb, k[:, :, lo:b]) * scale
        keys, queries = torch.arange(lo, b, device=q.device), torch.arange(a, b, device=q.device)
        masked = keys[None, :] > queries[:, None]
        if window:
            masked |= keys[None, :] <= queries[:, None] - window
        p = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1)
        out = torch.einsum("bhgst,bhtd->bhgsd", q_ops(p), v[:, :, lo:b])
        outs.append(out.reshape(B, H, b - a, D))
    return torch.cat(outs, dim=2)


def mlp(x, wi, wo, q_ops):
    gate, up = (q_ops(x) @ q_ops(wi)).chunk(2, dim=-1)
    return q_ops(F.silu(gate) * up) @ q_ops(wo)


def layer(h, lw: dict, s, positions, q_ops, window: int = 0, routed=None):
    """A layer on h (B, S, d), its attention under ``window`` (0: full). A
    mixture of experts takes ``routed`` (capacity factor, given experts or
    None) and returns ``(h, read)``."""
    B, S, _ = h.shape
    H, Hkv, D = s.heads, s.kv_heads, s.head_dim
    x = rmsnorm(h, lw["ln1"], s.norm_eps)
    q, k, v = (q_ops(x) @ q_ops(lw["attn"]["wqkv"])).split([H * D, Hkv * D, Hkv * D], dim=-1)
    q = rope(q.reshape(B, S, H, D).transpose(1, 2), positions, s.rope_theta)
    k = rope(k.reshape(B, S, Hkv, D).transpose(1, 2), positions, s.rope_theta)
    v = v.reshape(B, S, Hkv, D).transpose(1, 2)
    a = attention(q, k, v, s.scale, q_ops, window).transpose(1, 2).reshape(B, S, H * D)
    h = h + q_ops(a) @ q_ops(lw["attn"]["wo"])
    x = rmsnorm(h, lw["ln2"], s.norm_eps)
    if s.experts:
        y, read = moe.layer(x, lw["moe"], s, q_ops, *routed)
        return h + y, read
    return h + mlp(x, lw["mlp"]["wi"], lw["mlp"]["wo"], q_ops)


def _layer_weights(w: dict, i: int) -> dict:
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return take(w["layers"])


def hidden(w: dict, s, tokens, q_ops, remat: bool, routing: moe.Routing | None = None):
    """The final norm's output (B, S, d) over ``tokens`` (B, S); a mixture
    of experts routes by ``routing``, which keeps what each layer read."""
    h = w["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if s.experts:
        routing.start_step()
    for i in range(s.layers):
        args = (h, _layer_weights(w, i), s, positions, q_ops, s.windows[i])
        if s.experts:
            args += ((routing.capacity_factor, routing.choices(i)),)
        h = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
        if s.experts:
            h, routing.reads[-1][i] = h
    return rmsnorm(h, w["final_norm"], s.norm_eps)


def head(w: dict, s):
    return w["embed"].T if s.tie else w["lm_head"]


def loss(w: dict, s, tokens, prec: str = "float32",
         routing: moe.Routing | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy (position t predicts token t + 1); a
    mixture of experts adds its load-balancing term at ``routing``'s
    weight."""
    q_ops = _ops(prec)
    logits = q_ops(hidden(w, s, tokens, q_ops, True, routing)[:, :-1]) @ q_ops(head(w, s))
    value = (torch.logsumexp(logits, -1) - logits.gather(-1, tokens[:, 1:, None])[..., 0]).mean()
    if s.experts and routing.aux_weight:
        aux = moe.aux_loss(w["embed"][tokens], w["layers"]["moe"]["router"][0], s, q_ops)
        value = value + routing.aux_weight * aux
    return value


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lr_at(step: int, opt: dict) -> float:
    warm, total, base = opt["warmup_steps"], opt["total_steps"], opt["base_lr"]
    if step < warm:
        return base * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))


def train(w: dict, s, batches: list, opt: dict, start, prec: str = "float32",
          routing: moe.Routing | None = None) -> dict:
    """AdamW steps on ``w`` (float32 leaves, updated in place) over
    ``batches`` (token tensors): the losses, each leaf's norm of the first
    step's gradient after clipping, and each leaf's norm of its change over
    all the steps against ``start(path)``, its value before them; a mixture
    of experts also what its layers read of the routing (``route``:
    ``Routing.summary``)."""
    paths = [p for p, _ in _leaves(w)]
    params = [t for _, t in _leaves(w)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    out = {"losses": [], "grad_norms": {}, "change_norms": {}}
    for t, tokens in enumerate(batches, start=1):
        for p in params:
            p.requires_grad_(True)
        value = loss(w, s, tokens, prec, routing)
        grads = torch.autograd.grad(value, params)
        out["losses"].append(float(value.detach()))
        del value
        with torch.no_grad():
            for p in params:
                p.requires_grad_(False)
            gnorm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-12), max=1.0)
            lr = lr_at(t, opt)
            for path, p, g, m, v in zip(paths, params, grads, mu, nu):
                g = g * scale
                if t == 1:
                    out["grad_norms"][path] = float(torch.linalg.vector_norm(g))
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
                if p.dim() >= 2:
                    delta = delta + opt["weight_decay"] * p
                p.sub_(lr * delta)
            del grads
    with torch.no_grad():
        for path, p in zip(paths, params):
            out["change_norms"][path] = float(torch.linalg.vector_norm(p - start(path)))
    if s.experts:
        out["route"] = routing.summary()
    return out


@torch.no_grad()
def logits_at(w: dict, s, seqs, positions: list, prec: str = "float32",
              rows: int = 2) -> torch.Tensor:
    """The logits (n, len(positions), V) of the full forward over ``seqs``
    (n, T) at ``positions``, ``rows`` sequences at a time."""
    q_ops = _ops(prec)
    out = []
    for a in range(0, seqs.shape[0], rows):
        h = hidden(w, s, seqs[a:a + rows], q_ops, remat=False)[:, positions]
        out.append(q_ops(h) @ q_ops(head(w, s)))
    return torch.cat(out)
