#!/usr/bin/env python3
"""Control for chip_smoke.py's bf16 train-step comparison: deliberately wrong
kernels must fail it.

    python3 tools/train_parity_control.py

Runs chip_smoke.bf16_step_vs_plain (one bf16 forward + backward of qwen3-8b
at full width, 2 layers, B=4 S=1024, through the kernels and through their
plain versions) with the real kernels, then once for each mutant below, which
wraps a kernel's wrapper where the model's ops call it and spoils its output
as a kernel bug would. Each line gives the loss gap and the worst grad leaf's
rel beside chip_smoke's bounds, and whether the comparison caught the fault.
Exits 1 if the real kernels fail the bounds or a mutant passes them. Needs a
card; prints the card's name and power limit first.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on sys.path)


def _flash_kv_heads_shifted(real):
    """GQA maps query head h to kv head h // group + 1 (mod Hkv)."""
    def fn(q, k, v, **kw):
        return real(q, k.roll(1, dims=1), v.roll(1, dims=1), **kw)
    return fn


def _flash_tail_tile_dropped(real):
    """The last 64-row query tile of every head is never written (zeros)."""
    def fn(q, k, v, **kw):
        out, lse = real(q, k, v, **kw)
        out = out.clone()
        out[:, :, -64:] = 0
        return out, lse
    return fn


def _flash_scale_off(real):
    """Scores scaled by 1.05 / sqrt(D) instead of 1 / sqrt(D)."""
    def fn(q, k, v, *, causal=True, sm_scale=None, **kw):
        scale = (sm_scale or q.shape[-1] ** -0.5) * 1.05
        return real(q, k, v, causal=causal, sm_scale=scale, **kw)
    return fn


def _flash_bwd_scale_off(real):
    """The backward's softmax scale 5% high (the forward's is right)."""
    def fn(q, k, v, out, lse, dout, *, causal=True, sm_scale=None, **kw):
        scale = (sm_scale or q.shape[-1] ** -0.5) * 1.05
        return real(q, k, v, out, lse, dout, causal=causal, sm_scale=scale, **kw)
    return fn


def _flash_bwd_group_head_dropped(real):
    """dk and dv leave out the last q head of each kv head's group."""
    def fn(q, k, v, out, lse, dout, **kw):
        group = q.shape[1] // k.shape[1]
        dq, _, _ = real(q, k, v, out, lse, dout, **kw)
        kept = dout.clone()
        kept[:, group - 1::group] = 0
        _, dk, dv = real(q, k, v, out, lse, kept, **kw)
        return dq, dk, dv
    return fn


def _rmsnorm_tail_rows_raw(real):
    """The last 64 rows of each call are copied through unnormalised."""
    def fn(x, weight, eps=1e-6):
        y = real(x, weight, eps)
        rows = y.view(-1, y.shape[-1])
        rows[-64:] = x.reshape(-1, x.shape[-1])[-64:]
        return y
    return fn


def _rmsnorm_eps_off(real):
    """eps 1e-2 instead of the caller's."""
    def fn(x, weight, eps=1e-6):
        return real(x, weight, 1e-2)
    return fn


MUTANTS = {
    "flash: kv heads shifted by one": ("flash_attention_fwd", _flash_kv_heads_shifted),
    "flash: last query tile dropped": ("flash_attention_fwd", _flash_tail_tile_dropped),
    "flash: softmax scale 5% high": ("flash_attention_fwd", _flash_scale_off),
    "flash backward: softmax scale 5% high": ("flash_attention_bwd", _flash_bwd_scale_off),
    "flash backward: one q head of each group left out of dk, dv":
        ("flash_attention_bwd", _flash_bwd_group_head_dropped),
    "rmsnorm: last 64 rows unnormalised": ("rmsnorm_fwd", _rmsnorm_tail_rows_raw),
    "rmsnorm: eps 1e-2": ("rmsnorm_fwd", _rmsnorm_eps_off),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_parity_control: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import load_kernels
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    from repro_torch.kernels.ssd import ssd_scan_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    load_kernels()
    dev = torch.device("cuda", 0)
    counters = (rmsnorm_fwd, flash_attention_fwd, ssd_scan_fwd)
    bounds = f"bounds: loss {smoke.TRAIN_BF16_LOSS_TOL}, grad rel {smoke.TRAIN_BF16_GRAD_REL}"
    print(bounds, flush=True)
    failed = False
    for name, (attr, make) in [("the real kernels", (None, None)), *MUTANTS.items()]:
        real = getattr(ops, attr) if attr else None
        if attr:
            setattr(ops, attr, make(real))
        try:
            r = smoke.bf16_step_vs_plain(dev, counters)
        finally:
            if attr:
                setattr(ops, attr, real)
        smoke._free()
        passes = (r["d_loss"] <= smoke.TRAIN_BF16_LOSS_TOL
                  and r["grad_rel"] <= smoke.TRAIN_BF16_GRAD_REL)
        verdict = ("passes" if passes else "FAILS") if not attr else (
            "missed" if passes else "caught")
        failed |= passes == bool(attr)
        print(f"{name}: loss gap {r['d_loss']:.3e}"
              f"{' (caught)' if r['d_loss'] > smoke.TRAIN_BF16_LOSS_TOL else ''}, worst grad "
              f"leaf {r['leaf']} rel {r['grad_rel']:.3e}"
              f"{' (caught)' if r['grad_rel'] > smoke.TRAIN_BF16_GRAD_REL else ''}; {verdict}",
              flush=True)
        if not attr:
            print("  every grad leaf's rel: " + ", ".join(
                f"{k} {v:.3e}" for k, v in r["rels"].items()), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
