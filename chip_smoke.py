#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py     # 42 layers; 2 face + audio requests and 1 audio-only, 2 steps
                              # each; then 2 optimizer steps of the Stage-3 train step

Phases (one line each; any failure exits non-zero and prints no result):
  1. the card's `nvidia-smi` name and power limit; build every kernel (one
     nvcc per CUDA source, all at once).
  2. each kernel (B1 flash attention, fused and bare; B2 and B3 short-KV
     attention; B4 pair-axis attention; B5 and B5' tiny-sequence attention;
     B6 LayerNorm; the training path's B7 flash attention forward and
     backward, B8 tiny-sequence backward, B9 LayerNorm backward, B10
     per-head LayerNorm forward and backward; and the general-layout
     kernels: B11 flash attention forward over [B, H, S, D] / [B, S, H, D]
     (QK-LN + RoPE, RoPE, bare, D = 128), its fused backward B12 + B13 (dq,
     dk, dv in one launch, the kernel B7's backward shares) in both layouts, B14 q-major short-KV attention (combined and
     per identity), B2c and B2h head-major short-KV attention (combined,
     per identity)) against its plain PyTorch version on the card, at the
     serving or train step's shapes and at a ragged shape, with the stated
     tolerance; kernel, plain version and (where one PyTorch call computes
     the same function) that library call timed, and the bound computed.
  3. a reduced audio-only DiT step and a reduced fully conditioned one
     (face + audio, 3 latent frames so B5' runs) on the card (kernels, bf16)
     against the same weights on the CPU (plain versions, fp32); the face
     step's kernel launches are counted.
  3b. a reduced train step (2 layers, dim 768, 8 frames, 1,040 tokens):
     `Trainer.loss_and_metrics` forward and backward on the card against
     the CPU in fp32, loss, metrics and every trainable gradient compared,
     launch counts checked.
  3c. the same with 15 x 64 heads (dim 960, audio only), heads that do not
     pair in 128 lanes: the blocks' attention goes through
     `attention(layout="bshd")`, B11 forward and B12 + B13 backward.
  3d. the general-layout entry points once each at the 5B geometries
     (`attention(layout="bshd", qk_norm=...)`, `flash_attention(layout=
     "bhsd")` forward and backward, the four JAX-layout short-KV entry
     points), outputs against the plain versions, exact launch counts.
  4. the port's `InferenceServer` answers 2 face + audio requests and 1
     audio-only request through `pipeline.generate` on one fully
     conditioned DiT at the 5B geometry (dim 3072, 48 x 64 heads, 226 +
     17,550 tokens, 21 face layers with the router, 49 x 480 x 720 video)
     with random weights drawn on the card from a seed; output shape,
     finiteness and each kernel's launch count are checked.
  5. 2 optimizer steps (2 micro-batches each) of `Trainer.train_step` on the
     default configuration at full width (LoRA r128, nested per-group
     checkpointing, 42 layers): finite metrics, moved trainable and
     bit-identical frozen tensors, exact launch counts, peak memory.
Then a JSON line with the kernels, and as the last line the device JSON.
There is no CPU fallback: without a CUDA device it fails at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def _time_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median device time of `fn` in ms (CUDA events around each run)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# H100 SXM data-sheet peaks: HBM3 bandwidth and dense tensor-core/FP32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def _bound(nbytes: float, flops: float, kind: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _compare(got, want, atol: float, rtol: float):
    """(max |got - want|, max relative error, ok) with ok meaning
    |got - want| <= atol + rtol * |want| everywhere and all finite."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(g.isfinite().all()) and bool((diff <= atol + rtol * w.abs()).all())
    rel = float((diff / w.abs().clamp_min(1e-3)).max())
    return float(diff.max()), rel, ok


def kernel_phase(results: dict) -> bool:
    """Kernels vs plain versions at the serving path's shapes and at one
    ragged shape each; records the serving-shape numbers in `results`."""
    import torch
    import torch.nn.functional as F
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import layernorm as ln
    from bindyouravatar_tpu_torch.ops import packed_attention as pa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv
    from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1234)
    rnd = lambda *shape, std=1.0, mean=0.0: (
        torch.randn(shape, generator=gen, device=dev) * std + mean)
    bf = torch.bfloat16
    ok_all = True

    def report(name, tag, got, want, atol, rtol, kern, plain, runs, library=None, work=None):
        """Compare, time kernel / plain / library call; `work` = (bytes,
        flops, peak kind) of the call for its bound."""
        nonlocal ok_all
        err, rel, ok = _compare(got, want, atol, rtol)
        ms, plain_ms = _time_ms(kern, runs), _time_ms(plain, max(1, runs // 2))
        lib_ms = None if library is None else _time_ms(library, runs)
        bound_ms, bound_by = _bound(*work) if work is not None else (None, None)
        ok_all &= ok
        extra = "" if bound_ms is None else f" bound_ms={bound_ms:.4f} ({bound_by})"
        extra += f" library_ms={'none' if lib_ms is None else f'{lib_ms:.4f}'}"
        print(f"kernel {name} {tag}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"tol=|d|<={atol}+{rtol}*|ref| {'ok' if ok else 'FAILED'} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}{extra}", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    def report_all(name, tag, gots, wants, rels, kern, plain, runs, library, work):
        """One line per output (first one timed), each within `rel` of the
        reference's largest magnitude (+ `rel` relative); ok only if all
        agree."""
        nonlocal ok_all
        r = None
        for i, (got, want, rel) in enumerate(zip(gots, wants, rels)):
            sub = f"{tag} out{i}"
            if i == 0:
                r = report(name, sub, got, want, _rel_compare(got, want, rel), rel, kern, plain,
                           runs, library, work)
            else:
                err, relerr, ok = _compare(got, want, _rel_compare(got, want, rel), rel)
                ok_all &= ok
                print(f"kernel {name} {sub}: max_abs_err={err:.3e} max_rel_err={relerr:.3e} "
                      f"tol=|d|<={_rel_compare(got, want, rel):.3e}+{rel}*|ref| "
                      f"{'ok' if ok else 'FAILED'}", flush=True)
                r["max_abs_err"] = max(r["max_abs_err"], err)
        return r

    def bhsd(t, h):
        """[B, S, H*D] -> contiguous [B, H, S, D]: the library call's layout
        (made before timing, so the permute is not in library_ms)."""
        b, s_, hd = t.shape
        return t.reshape(b, s_, h, hd // h).transpose(1, 2).contiguous()

    # --- B1: joint self-attention, q/k/v [2, 17776, 48*64]; ragged S=1000 with
    # a masked kv tail; the bare path (no LN, no RoPE) of the STAB spatial
    # attention at [52, 1350, 8*64] and at a ragged S=777.
    # tol: both sides round LN/RoPE outputs and p to bf16; the kernel also
    # rounds the scaled q (one more bf16 ulp, ~0.4% of a logit).
    # library: SDPA computes the bare function only (no QK-LN, no RoPE).
    for tag, b, s, h, text_len, grid, kv_len in (
            ("slice[2,17776,3072]", 2, 17776, 48, 226, (13, 30, 45), None),
            ("ragged[1,1000,512] kv_len=937", 1, 1000, 8, 10, (3, 18, 18), 937),
            ("bare[52,1350,512] no LN/RoPE", 52, 1350, 8, 0, None, None),
            ("ragged[2,777,256] no LN/RoPE", 2, 777, 4, 0, None, None)):
        q, k, v = (rnd(b, s, h * 64).to(bf) for _ in range(3))
        kw = dict(kv_len=kv_len)
        library = None
        if grid is not None:
            rope = get_3d_rotary_pos_embed(64, ((0, 0), grid[1:]), grid[1:], grid[0], device=dev)
            norm = (rnd(64, std=0.1, mean=1.0), rnd(64, std=0.1),
                    rnd(64, std=0.1, mean=1.0), rnd(64, std=0.1))
            kw.update(rope=rope, rope_start=text_len, qk_norm=norm)
        else:
            qb, kb, vb = bhsd(q, h), bhsd(k, h), bhsd(v, h)
            library = lambda: F.scaled_dot_product_attention(qb, kb, vb)
        kern = lambda: fa.flash_attention(q, k, v, h, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, h, block_q=512, **kw)
        work = (_nbytes(q, k, v, q), 4.0 * b * h * s * (kv_len or s) * 64, "bf16")
        r = report("B1", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 5, library, work)
        if tag.startswith(("slice", "bare")):
            results["B1" if tag.startswith("slice") else "B1 bare"] = r

    # --- B2: perceiver face attention, q [2, 17550, 16*128], k/v [2, 2, 16, 32,
    # 128], one output per identity; ragged Sq=1000.
    # tol: the plain version rounds p and each output to bf16 as the kernel
    # does; fp32 sums in another order.
    # library: SDPA with the identities folded into the heads (q repeated
    # per identity before timing), output [B, I*H, Sq, 128].
    for tag, b, sq in (("slice[2,17550,2048] I=2 K=32", 2, 17550),
                       ("ragged[1,1000,2048] I=2 K=32", 1, 1000)):
        q = rnd(b, sq, 16 * 128).to(bf)
        k, v = (rnd(b, 2, 16, 32, 128).to(bf) for _ in range(2))
        kern = lambda: skv.short_kv_attention_flat(q, k, v, 128 ** -0.5)
        plain = lambda: skv.short_kv_attention_flat_plain(q, k, v, 128 ** -0.5)
        qi = bhsd(q, 16).unsqueeze(1).expand(b, 2, 16, sq, 128).reshape(b, 32, sq, 128)
        ki, vi = k.reshape(b, 32, 32, 128), v.reshape(b, 32, 32, 128)
        library = lambda: F.scaled_dot_product_attention(qi, ki, vi)
        work = (_nbytes(q, k, v) + 2 * _nbytes(q), 4.0 * b * 2 * 16 * sq * 32 * 128, "bf16")
        r = report("B2", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 20, library, work)
        if tag.startswith("slice"):
            results["B2"] = r

    # --- B3: audio cross-attention, q [26, 1350, 3072], k/v [26, 2, 48, 32, 64]
    # tol: the plain version rounds each identity's output and the combine
    # to bf16, the kernel sums in fp32 and rounds once.
    # library: none (no single call weights the identities' softmaxes).
    for tag, g, sq, w_uniform in (("slice[26,1350,3072] w=0.5", 26, 1350, True),
                                  ("slice[26,1350,3072] w~U(0,1)", 26, 1350, False),
                                  ("ragged[3,1000,3072]", 3, 1000, False)):
        q = rnd(g, sq, 48 * 64).to(bf)
        k, v = (rnd(g, 2, 48, 32, 64).to(bf) for _ in range(2))
        w = (torch.full((g, sq, 2), 0.5, device=dev) if w_uniform
             else torch.rand((g, sq, 2), generator=gen, device=dev)).to(bf)
        kern = lambda: skv.short_kv_attention_combined_flat(q, k, v, w, 0.125)
        plain = lambda: skv.short_kv_attention_combined_flat_plain(q, k, v, w, 0.125)
        work = (_nbytes(q, k, v, w, q), 4.0 * g * 2 * 48 * sq * 32 * 64, "bf16")
        r = report("B3", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 20, None, work)
        if tag.startswith("slice") and w_uniform:
            results["B3"] = r

    # --- B4: multi-ID STAB attention, q/k/v [2, 2, 17550, 8*64]; ragged M=1001.
    # tol: both sides compute in fp32 and round once (one bf16 ulp).
    # library: SDPA over the pair axis on a [B*M, H, 2, 64] copy (permuted
    # before timing).
    for tag, b, m in (("slice[2,2,17550,512]", 2, 17550), ("ragged[1,2,1001,512]", 1, 1001)):
        q, k, v = (rnd(b, 2, m, 512).to(bf) for _ in range(3))
        kern = lambda: pa.pair_axis_attention(q, k, v, 8, 0.125)
        plain = lambda: pa.pair_axis_attention_plain(q, k, v, 8, 0.125)
        pairs = lambda t: t.reshape(b, 2, m, 8, 64).permute(0, 2, 3, 1, 4).reshape(
            b * m, 8, 2, 64).contiguous()
        qp, kp, vp = pairs(q), pairs(k), pairs(v)
        library = lambda: F.scaled_dot_product_attention(qp, kp, vp, scale=0.125)
        work = (_nbytes(q, k, v, q), 15.0 * b * m * 512, "fp32")
        r = report("B4", tag, kern(), plain(), 1e-2, 1e-2, kern, plain, 20, library, work)
        if tag.startswith("slice"):
            results["B4"] = r

    # --- B5: temporal STAB attention [5400, 13, 8*64]; ragged M=1001.  B5':
    # the same kernel for S < 8 through `packed_head_attention` on the
    # packed [M, S*8, 64] view, at S = 3 (the reduced step's frames) and 2.
    # tol: both sides round p to bf16; fp32 sums in another order.
    # library: SDPA on a [M, 8, S, 64] copy (permuted before timing).
    for name, tag, m, s in (("B5", "slice[5400,13,512]", 5400, 13),
                            ("B5", "ragged[1001,13,512]", 1001, 13),
                            ("B5'", "slice[5400,3,512]", 5400, 3),
                            ("B5'", "slice[5400,2,512]", 5400, 2)):
        q, k, v = (rnd(m, s, 512).to(bf) for _ in range(3))
        if name == "B5":
            kern = lambda: pa.tiny_seq_attention(q, k, v, 8, 0.125)
            plain = lambda: pa.tiny_seq_attention_plain(q, k, v, 8, 0.125)
        else:
            packed = [t.reshape(m, s * 8, 64) for t in (q, k, v)]
            kern = lambda: pa.packed_head_attention(*packed, 8, 0.125)
            plain = lambda: pa.packed_head_attention_plain(*packed, 8, 0.125)
        qh, kh, vh = bhsd(q, 8), bhsd(k, 8), bhsd(v, 8)
        library = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)
        work = (_nbytes(q, k, v, q), 4.0 * m * 8 * s * s * 64, "bf16")
        got = kern().reshape(m, s, 512)
        r = report(name, tag, got, plain().reshape(m, s, 512), 1e-2, 2e-2, kern, plain, 20,
                   library, work)
        if tag.startswith("slice") and name not in results:
            results[name] = r

    # --- B6: audio norm_q rows [2*17550, 3072], AudioProjModel [2*2*13*32, 768];
    # the face path's widths: router norms [35100, 2048], STAB/trunk [70200, 512]
    # tol: one bf16 rounding of the same fp32 value, summed in another order
    # library: F.layer_norm (affine cast to bf16 before timing)
    for tag, rows, d in (("slice[35100,3072]", 35100, 3072), ("slice[1664,768]", 1664, 768),
                         ("slice[35100,2048]", 35100, 2048), ("slice[70200,512]", 70200, 512),
                         ("ragged[1001,768]", 1001, 768)):
        x = rnd(rows, d, std=2.3, mean=0.7).to(bf)
        sc, bi = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1)
        scb, bib = sc.to(bf), bi.to(bf)
        kern = lambda: ln.fused_layernorm(x, sc, bi)
        plain = lambda: ln.layernorm_plain(x, sc, bi)
        library = lambda: F.layer_norm(x, (d,), scb, bib, 1e-5)
        work = (_nbytes(x, sc, bi, x), 8.0 * rows * d, "fp32")
        r = report("B6", tag, kern(), plain(), 1e-2, 1e-2, kern, plain, 20, library, work)
        if tag == "slice[35100,3072]":
            results["B6"] = r
    # report() and report_all() clear ok_all themselves
    train_kernel_phase(results, rnd, report, report_all, bhsd)
    layout_kernel_phase(results, rnd, report, report_all)
    return ok_all


def _rel_compare(got, want, rel: float) -> float:
    """The absolute tolerance `rel` times the reference's largest magnitude
    (for gradients, whose scale depends on the shape)."""
    return rel * float(want.float().abs().max())


def train_kernel_phase(results: dict, rnd, report, report_all, bhsd) -> None:
    """The training path's kernels (B7 forward and backward, B8, B9, B10
    forward and backward) against their plain versions, at the train
    step's shapes (batch 1 per micro-batch) and one ragged shape each."""
    import torch
    import torch.nn.functional as F
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import layernorm as ln
    from bindyouravatar_tpu_torch.ops import packed_attention as pa
    from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed

    dev = torch.device("cuda")
    bf = torch.bfloat16

    # --- B7: the training attention.  DiT blocks q/k/v [1, 17776, 48*64] with
    # RoPE on rows 226..17775; STAB spatial [26, 1350, 8*64] without; ragged
    # [1, 1000, 8*64] with a masked kv tail (937) and RoPE from row 10.
    # tol (forward): as B1, one more bf16 ulp on the scaled q; the LSE to
    # 3e-2 absolute (logits rounded to bf16, values ~10).
    # tol (backward): 2% of each gradient's largest magnitude (+2% relative):
    # both sides round P and dS to bf16; the kernel's P comes from the
    # bf16-rounded scaled q, and its sums over 17,776 kv rows run in
    # another order (dq's across kv tiles by fp32 atomic adds, in no fixed
    # order).
    # library: SDPA (forward; forward + autograd backward timed as the
    # backward alone) at the bare shape only: no PyTorch call applies RoPE.
    for tag, b, s, h, text_len, grid, kv_len in (
            ("train[1,17776,3072] rope", 1, 17776, 48, 226, (13, 30, 45), None),
            ("bare[26,1350,512]", 26, 1350, 8, 0, None, None),
            ("ragged[1,1000,512] kv_len=937 rope", 1, 1000, 8, 10, (3, 18, 18), 937)):
        q, k, v, do = (rnd(b, s, h * 64).to(bf) for _ in range(4))
        kw = dict(kv_len=kv_len)
        lib_f = lib_b = None
        if grid is not None:
            kw.update(rope=get_3d_rotary_pos_embed(64, ((0, 0), grid[1:]), grid[1:], grid[0],
                                                   device=dev), rope_start=text_len)
        else:
            qb, kb, vb = (bhsd(t, h).requires_grad_() for t in (q, k, v))
            ob = F.scaled_dot_product_attention(qb, kb, vb)
            dob = bhsd(do, h)
            lib_f = lambda: F.scaled_dot_product_attention(qb, kb, vb)
            lib_b = lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True)
        kv = kv_len or s
        fwd = lambda: fa.flash_attention_flat_fwd(q, k, v, h, **kw)
        fwd_plain = lambda: fa.flash_attention_flat_fwd_plain(q, k, v, h, block_q=512, **kw)
        o, lse = fwd()
        o_p, lse_p = fwd_plain()
        work = (_nbytes(q, k, v, o, lse), 4.0 * b * h * s * kv * 64, "bf16")
        r = report_all("B7 fwd", tag, (o, lse), (o_p, lse_p), (2e-2, 3e-3), fwd, fwd_plain,
                       3, lib_f, work)
        delta = fa.attention_delta(o, do, h)
        bwd = lambda: fa.flash_attention_flat_bwd(q, k, v, do, lse, delta, h, **kw)
        bwd_plain = lambda: fa.flash_attention_flat_bwd_plain(q, k, v, do, lse, delta, h,
                                                              block_q=512, **kw)
        work = (_nbytes(q, k, v, do, lse, delta, q, k, v), 10.0 * b * h * s * kv * 64, "bf16")
        r_b = report_all("B7 bwd", tag, bwd(), bwd_plain(), (2e-2, 2e-2, 2e-2), bwd, bwd_plain,
                         3, lib_b, work)
        if tag.startswith("train"):
            results["B7 fwd"], results["B7 bwd"] = r, r_b
        del q, k, v, do, o, lse, o_p, lse_p, delta

    # --- B8: temporal STAB attention backward [2700, 13, 8*64] (batch 1:
    # M = 2 identities x 30 x 45); ragged M = 1001.
    # tol: both sides compute the softmax vjp in fp32 from the same bf16
    # inputs and round once: 1e-2 of each gradient's largest magnitude.
    # library: SDPA at S = 13 on [M, 8, 13, 64] copies, its autograd
    # backward timed alone.
    for tag, m in (("train[2700,13,512]", 2700), ("ragged[1001,13,512]", 1001)):
        q, k, v, g = (rnd(m, 13, 512).to(bf) for _ in range(4))
        qh, kh, vh = (bhsd(t, 8).requires_grad_() for t in (q, k, v))
        oh = F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)
        gh = bhsd(g, 8)
        lib = lambda: torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True)
        kern = lambda: pa.tiny_seq_attention_bwd(q, k, v, g, 8, 0.125)
        plain = lambda: pa.tiny_seq_attention_bwd_plain(q, k, v, g, 8, 0.125)
        work = (_nbytes(q, k, v, g, q, k, v), 10.0 * m * 8 * 13 * 13 * 64, "fp32")
        r = report_all("B8", tag, kern(), plain(), (1e-2,) * 3, kern, plain, 20, lib, work)
        if tag.startswith("train"):
            results["B8"] = r

    # --- B9: row LayerNorm backward.  Audio norm_q and perceiver norm2
    # [17550, 3072], router norm_q [17550, 2048], trunk/STAB norms
    # [35100, 512], perceiver norm1 on the face tokens [64, 2048]; ragged
    # [1001, 768].  B10: per-head LayerNorm of q/k [17776, 48 x 64],
    # forward and backward; ragged [1001, 8 x 64].
    # tol: dx one bf16 rounding of the same fp32 value (1e-2 of the largest
    # |dx|); dscale/dbias fp32 sums over the rows in another order (1e-3).
    # library: F.layer_norm's autograd backward (B9), F.layer_norm on the
    # [M, H, 64] view forward and its backward (B10), timed alone.
    for name, tag, rows, d in (("B9", "train[17550,3072]", 17550, 3072),
                               ("B9", "train[17550,2048]", 17550, 2048),
                               ("B9", "train[35100,512]", 35100, 512),
                               ("B9", "train[64,2048]", 64, 2048),
                               ("B9", "ragged[1001,768]", 1001, 768),
                               ("B10", "train[17776,3072]", 17776, 3072),
                               ("B10", "ragged[1001,512]", 1001, 512)):
        x = rnd(rows, d, std=2.3, mean=0.7).to(bf)
        g = rnd(rows, d).to(bf)
        w_d = 64 if name == "B10" else d
        sc, bi = rnd(w_d, std=0.1, mean=1.0), rnd(w_d, std=0.1)
        view = (lambda t: t.reshape(rows, d // 64, 64)) if name == "B10" else (lambda t: t)
        xl = view(x).detach().requires_grad_()
        scl, bil = sc.to(bf).requires_grad_(), bi.to(bf).requires_grad_()
        yl = F.layer_norm(xl, (w_d,), scl, bil, 1e-6 if name == "B10" else 1e-5)
        lib_b = lambda: torch.autograd.grad(yl, (xl, scl, bil), view(g), retain_graph=True)
        if name == "B10":
            eps = 1e-6
            fk = lambda: ln.head_layernorm_fwd(x, sc, bi, eps)
            fp = lambda: ln.head_layernorm_plain(x, sc, bi, eps)
            lib_f = lambda: F.layer_norm(view(x), (64,), sc.to(bf), bi.to(bf), eps)
            r = report("B10 fwd", tag, fk(), fp(), 1e-2, 1e-2, fk, fp, 20, lib_f,
                       (_nbytes(x, sc, bi, x), 8.0 * rows * d, "fp32"))
            if tag.startswith("train"):
                results["B10 fwd"] = r
            kern = lambda: ln.head_layernorm_bwd(x, sc, g, eps)
            plain = lambda: ln.head_layernorm_bwd_plain(x, sc, g, eps)
        else:
            kern = lambda: ln.layernorm_bwd(x, sc, g)
            plain = lambda: ln.layernorm_bwd_plain(x, sc, g)
        work = (_nbytes(x, sc, g, x, sc, bi), 12.0 * rows * d, "fp32")
        key = "B10 bwd" if name == "B10" else "B9"
        r = report_all(key, tag, kern(), plain(), (1e-2, 1e-3, 1e-3), kern, plain, 20, lib_b,
                       work)
        if tag in ("train[17550,3072]", "train[17776,3072]"):
            results[key] = r


def layout_kernel_phase(results: dict, rnd, report, report_all) -> None:
    """The general-layout kernels (B11 forward, B12 + B13 backward, B14,
    B2c and B2h short-KV attention) against their plain versions at the 5B
    geometries and at ragged shapes."""
    import torch
    import torch.nn.functional as F
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv
    from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed

    dev = torch.device("cuda")
    bf = torch.bfloat16

    # --- B11 and B12 + B13: the joint-attention geometry in both layouts.  bshd
    # [2, 17776, 48, 64] with QK-LN and RoPE (rows 226..17775: B1's work);
    # bhsd [1, 48, 17776, 64] and bshd [1, 17776, 48, 64] with RoPE (the
    # train step's); bare bhsd [2, 48, 17776, 64]; D = 128 at the same width
    # [1, 24, 17776, 128] with RoPE; phase 3c's unpaired heads, bshd
    # [1, 1040, 15, 64] with RoPE from row 16; ragged S = 1000 with kv_len
    # 937 in both layouts (bshd with and without QK-LN).  The backward runs
    # on every case without QK-LN, so both row strides (bhsd rows D apart,
    # bshd rows H*D apart) are held against the plain versions.
    # tol (forward): one bf16 rounding of LN and RoPE outputs and of p on
    # both sides, fp32 sums in another order: 2% of the output's largest
    # magnitude (+2% relative); the LSE 3e-3 of its largest magnitude.
    # tol (backward): as B7, 2% of each gradient's largest magnitude: both
    # sides round P and dS to bf16, sums over 17,776 rows in another order
    # (dq's across kv tiles by fp32 atomic adds, in no fixed order).
    # library: SDPA (forward; forward + autograd backward timed as the
    # backward alone) at the bare shape only: no PyTorch call applies RoPE
    # or the QK-LN.
    cases = (("bshd[2,17776,48,64] LN+RoPE", "bshd", 2, 17776, 48, 64, 226, (13, 30, 45), True,
              None),
             ("bhsd[1,48,17776,64] RoPE", "bhsd", 1, 17776, 48, 64, 226, (13, 30, 45), False,
              None),
             ("bshd[1,17776,48,64] RoPE", "bshd", 1, 17776, 48, 64, 226, (13, 30, 45), False,
              None),
             ("unpaired bshd[1,1040,15,64] RoPE", "bshd", 1, 1040, 15, 64, 16, (8, 8, 16), False,
              None),
             ("bare bhsd[2,48,17776,64]", "bhsd", 2, 17776, 48, 64, 0, None, False, None),
             ("D=128 bhsd[1,24,17776,128] RoPE", "bhsd", 1, 17776, 24, 128, 226, (13, 30, 45),
              False, None),
             ("ragged bshd[1,1000,8,64] kv_len=937 LN+RoPE", "bshd", 1, 1000, 8, 64, 10,
              (3, 18, 18), True, 937),
             ("ragged bshd[1,1000,8,64] kv_len=937 RoPE", "bshd", 1, 1000, 8, 64, 10,
              (3, 18, 18), False, 937),
             ("ragged bhsd[1,8,1000,64] kv_len=937 RoPE", "bhsd", 1, 1000, 8, 64, 10,
              (3, 18, 18), False, 937))
    for tag, layout, b, s, h, d, text_len, grid, ln_on, kv_len in cases:
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        q, k, v = (rnd(*shape).to(bf) for _ in range(3))
        kw = dict(layout=layout, kv_len=kv_len)
        if grid is not None:
            kw.update(rope=get_3d_rotary_pos_embed(d, ((0, 0), grid[1:]), grid[1:], grid[0],
                                                   device=dev), rope_start=text_len)
        if ln_on:
            kw["qk_norm"] = (rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1),
                             rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1))
        kv = kv_len or s
        lib_f = lib_b = None
        if tag.startswith("bare"):
            qb, kb, vb = (t.detach().requires_grad_() for t in (q, k, v))
            ob = F.scaled_dot_product_attention(qb, kb, vb)
            lib_f = lambda: F.scaled_dot_product_attention(qb, kb, vb)
            dob = rnd(*shape).to(bf)
            lib_b = lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True)
        fwd = lambda: fa.flash_attention_fwd(q, k, v, **kw)
        fwd_plain = lambda: fa.flash_attention_fwd_plain(q, k, v, block_q=512, **kw)
        o, lse = fwd()
        o_p, lse_p = fwd_plain()
        work = (_nbytes(q, k, v, o, lse), 4.0 * b * h * s * kv * d, "bf16")
        r = report_all("B11", tag, (o, lse), (o_p, lse_p), (2e-2, 3e-3), fwd, fwd_plain, 3, lib_f,
                       work)
        if tag.startswith("bshd[2"):
            results["B11"] = r
        del o_p, lse_p
        if ln_on:
            continue
        do = rnd(*shape).to(bf)
        bw = {key: val for key, val in kw.items() if key != "qk_norm"}
        bwd = lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, **bw)
        bwd_plain = lambda: fa.flash_attention_bwd_plain(q, k, v, o, do, lse, block_q=512, **bw)
        work = (_nbytes(q, k, v, o, do, lse, q, k, v), 10.0 * b * h * s * kv * d, "bf16")
        r_b = report_all("B12+B13", tag, bwd(), bwd_plain(), (2e-2, 2e-2, 2e-2), bwd, bwd_plain,
                         3, lib_b, work)
        if tag.startswith("bhsd[1,48"):
            results["B12+B13"] = r_b
        del q, k, v, o, lse, do

    # --- B14: the audio geometry combined, q [26, 1350, 48, 64], k/v [26, 2,
    # 48, 32, 64], w [26, 1350, 2]; the perceiver geometry per identity, q
    # [2, 17550, 16, 128]; ragged Sq = 1001 combined.  B2c: head-major
    # combined [26, 48, 1350, 64].  B2h (B2's body head-major) per identity
    # [2, 16, 17550, 128].
    # tol: the plain versions round each identity's output (and the
    # combine) to bf16, the kernels sum in fp32 and round once.
    # library: none for the combined calls (no single call weights the
    # identities' softmaxes); SDPA with the identities folded into the heads
    # for the per-identity call (q repeated before timing).
    for name, tag, g, sq, h, d, combine, qmajor in (
            ("B14", "combined[26,1350,48,64] I=2 K=32", 26, 1350, 48, 64, True, True),
            ("B14", "per-id[2,17550,16,128] I=2 K=32", 2, 17550, 16, 128, False, True),
            ("B14", "ragged combined[3,1001,48,64]", 3, 1001, 48, 64, True, True),
            ("B2c", "head-major combined[26,48,1350,64] I=2 K=32", 26, 1350, 48, 64, True,
             False),
            ("B2h", "head-major per-id[2,16,17550,128] I=2 K=32", 2, 17550, 16, 128, False,
             False)):
        q = rnd(*((g, sq, h, d) if qmajor else (g, h, sq, d))).to(bf)
        k, v = (rnd(g, 2, h, 32, d).to(bf) for _ in range(2))
        w = rnd(g, sq, 2).sigmoid().to(bf)
        fn = {(True, True): "short_kv_attention_combined_qmajor",
              (False, True): "short_kv_attention_qmajor",
              (True, False): "short_kv_attention_combined",
              (False, False): "short_kv_attention"}[(combine, qmajor)]
        args = (q, k, v, w) if combine else (q, k, v)
        kern = lambda: getattr(skv, fn)(*args, d ** -0.5)
        plain = lambda: getattr(skv, f"{fn}_plain")(*args, d ** -0.5)
        library = None
        if not combine:
            qh = q.transpose(1, 2) if qmajor else q
            qi = qh.unsqueeze(1).expand(g, 2, h, sq, d).reshape(g, 2 * h, sq, d).contiguous()
            ki, vi = k.reshape(g, 2 * h, 32, d), v.reshape(g, 2 * h, 32, d)
            library = lambda: F.scaled_dot_product_attention(qi, ki, vi)
        out_bytes = _nbytes(q) * (1 if combine else 2)
        work = (_nbytes(*args) + out_bytes, 4.0 * g * 2 * h * sq * 32 * d, "bf16")
        r = report(name, tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 20, library, work)
        if name not in results:
            results[name] = r


def entry_point_phase(launches: dict) -> bool:
    """The general-layout entry points a user calls, once each at the 5B
    geometries, forward and (where differentiable) backward, launches
    counted from 0: `attention(layout="bshd", qk_norm=...)` (inference,
    B11), `flash_attention(layout="bhsd")` with RoPE forward and backward
    (B11, B12 + B13), `short_kv_attention_combined_qmajor` (audio geometry)
    and `short_kv_attention_qmajor` (perceiver geometry; B14),
    `short_kv_attention_combined` (B2c) and `short_kv_attention` (B2h);
    outputs against the plain versions, gradients finite; fills
    `launches`."""
    import torch
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv
    from bindyouravatar_tpu_torch.ops.attention import attention
    from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(4321)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    rope = get_3d_rotary_pos_embed(64, ((0, 0), (30, 45)), (30, 45), 13, device=dev)
    norm = tuple(1.0 + 0.1 * torch.randn(64, generator=gen, device=dev) if i % 2 == 0
                 else 0.1 * torch.randn(64, generator=gen, device=dev) for i in range(4))
    q_bshd, k_bshd, v_bshd = (rnd(2, 17776, 48, 64) for _ in range(3))
    qkv = [rnd(1, 48, 17776, 64).requires_grad_() for _ in range(3)]
    do = rnd(1, 48, 17776, 64)
    q_a, q_p, q_h = rnd(26, 1350, 48, 64), rnd(2, 17550, 16, 128), rnd(26, 48, 1350, 64)
    kv_a = [rnd(26, 2, 48, 32, 64).requires_grad_() for _ in range(2)]
    kv_p = [rnd(2, 2, 16, 32, 128) for _ in range(2)]
    w = torch.rand((26, 1350, 2), generator=gen, device=dev).to(torch.bfloat16)
    calls = (
        ("attention bshd LN+RoPE", lambda: attention(q_bshd, k_bshd, v_bshd, rope=rope,
                                                     rope_start=226, layout="bshd",
                                                     qk_norm=norm),
         lambda: fa.flash_attention_fwd_plain(q_bshd, k_bshd, v_bshd, "bshd", rope=rope,
                                              rope_start=226, qk_norm=norm, block_q=512)[0],
         None),
        ("flash_attention bhsd RoPE", lambda: fa.flash_attention(*qkv, rope=rope,
                                                                 rope_start=226, layout="bhsd"),
         lambda: fa.flash_attention_fwd_plain(*qkv, "bhsd", rope=rope, rope_start=226,
                                              block_q=512)[0], (qkv, do)),
        ("short_kv_attention_combined_qmajor", lambda: skv.short_kv_attention_combined_qmajor(
            q_a, *kv_a, w, 0.125), lambda: skv.short_kv_attention_combined_qmajor_plain(
            q_a, *kv_a, w, 0.125), (kv_a, None)),
        ("short_kv_attention_qmajor",
         lambda: skv.short_kv_attention_qmajor(q_p, *kv_p, 128 ** -0.5),
         lambda: skv.short_kv_attention_qmajor_plain(q_p, *kv_p, 128 ** -0.5), None),
        ("short_kv_attention_combined", lambda: skv.short_kv_attention_combined(
            q_h, *kv_a, w, 0.125), lambda: skv.short_kv_attention_combined_plain(
            q_h, *kv_a, w, 0.125), (kv_a, None)),
        ("short_kv_attention", lambda: skv.short_kv_attention(q_h, *kv_a, 0.125),
         lambda: skv.short_kv_attention_plain(q_h, *kv_a, 0.125), None))
    ok = True
    outs = []
    torch.cuda.synchronize()
    _reset_launches()
    for name, call, _, grad in calls:
        out = call()
        finite = True
        if grad is not None:
            leaves, g = grad
            gs = torch.autograd.grad(out, leaves, out.detach() if g is None else g)
            finite = all(bool(t.isfinite().all()) for t in gs)
        outs.append((out.detach(), finite))
    torch.cuda.synchronize()
    launches.update(_read_launches())
    want = {k: 0 for k in _kernel_fns()}
    want.update({"B11": 2, "B12+B13": 1, "B14": 2, "B2c": 1, "B2h": 1})
    for (name, _, plain, _), (out, finite) in zip(calls, outs):
        with torch.no_grad():
            ref = plain()
        # tol: as phase 2 (bf16 roundings of the same fp32 values)
        err, _, match = _compare(out, ref, _rel_compare(out, ref, 2e-2), 2e-2)
        ok &= match and finite
        print(f"entry point {name}: output {tuple(out.shape)} max_abs_err={err:.3e} "
              f"gradients finite={finite} {'ok' if match and finite else 'FAILED'}", flush=True)
    counts_ok = launches == want
    ok &= counts_ok
    print("entry points: launches " + " ".join(f"{k}={launches[k]} (want {want[k]})"
                                                for k in want if want[k] or launches[k])
          + f" {'ok' if counts_ok else 'FAILED'}", flush=True)
    return ok


def _kernel_fns():
    """name -> kernel wrapper (its `launches` counts the kernel's launches)."""
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import layernorm as ln
    from bindyouravatar_tpu_torch.ops import packed_attention as pa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv

    return {"B1": fa.flash_attention, "B2": skv.short_kv_attention_flat,
            "B3": skv.short_kv_attention_combined_flat, "B4": pa.pair_axis_attention,
            "B5": pa.tiny_seq_attention, "B5'": pa.packed_head_attention,
            "B6": ln.fused_layernorm, "B7 fwd": fa.flash_attention_flat_fwd,
            "B7 bwd": fa.flash_attention_flat_bwd, "B8": pa.tiny_seq_attention_bwd,
            "B9": ln.layernorm_bwd, "B10 fwd": ln.head_layernorm_fwd,
            "B10 bwd": ln.head_layernorm_bwd, "B11": fa.flash_attention_fwd,
            "B12+B13": fa.flash_attention_bwd,
            "B14": skv.short_kv_attention_qmajor, "B2c": skv.short_kv_attention_combined,
            "B2h": skv.short_kv_attention}

TRAIN_KERNELS = ("B7 fwd", "B7 bwd", "B8", "B9", "B10 fwd", "B10 bwd")
LAYOUT_KERNELS = ("B11", "B12+B13", "B14", "B2c", "B2h")


def _reset_launches() -> None:
    for fn in _kernel_fns().values():
        fn.launches = 0


def _read_launches() -> dict:
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def reduced_step_phase(launches: dict) -> bool:
    """2-layer DiT steps at reduced widths on the card (kernels, bf16)
    against the same weights on the CPU (plain versions, fp32): audio-only,
    then fully conditioned (face + audio) at 3 latent frames, whose kernel
    launches go into `launches`."""
    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.config import AudioConfig, DiTConfig, LFEConfig, RouterConfig
    from bindyouravatar_tpu_torch.models.dit import DiT

    ok = True
    # face step widths the kernels take: inner 768 (12 x 64), router 4 heads
    # x 128 (q_k_dim 512 = the LFE output), 32 face tokens, feat_dim 128
    # (2 STAB heads x 64); a narrow LFE (it runs once per clip)
    for face in (False, True):
        heads = 12 if face else 4
        base = dict(num_attention_heads=heads, attention_head_dim=64, in_channels=48,
                    out_channels=16, time_embed_dim=64, text_embed_dim=128, num_layers=2,
                    sample_width=24, sample_height=16, sample_frames=9, max_text_seq_length=16,
                    is_train_face=face, fuse_qk_norm=True)
        acfg = AudioConfig(dim=heads * 64, audio_dim=128, num_attention_heads=heads,
                           attention_head_dim=64, num_layers=2, blocks=2, intermediate_dim=64,
                           context_tokens=32)
        rcfg = RouterConfig(num_layers=1, q_k_dim=512, num_heads=4, num_id_token=32,
                            attn_heads=2)
        lcfg = LFEConfig(dim=128, depth=5, dim_head=64, heads=2, num_id_token=2, num_queries=32,
                         output_dim=512, id_embed_dim=64, vit_dim=64)
        sub = (acfg, rcfg, lcfg)
        ref = DiT.create(DiTConfig(dtype=torch.float32, param_dtype=torch.float32, **base), *sub,
                         device="cpu", generator=torch.Generator().manual_seed(7))
        # fp32 weights (the config default) computed in bf16: the routing is
        # a sigmoid, and near 0.5 it passes on every rounding of the router
        gpu = DiT.create(DiTConfig(dtype=torch.bfloat16, param_dtype=torch.float32, **base),
                         *sub, device="cuda")
        gpu.load_state_dict(ref.state_dict())
        c = ref.cfg
        rng = np.random.default_rng(7)
        n_af = c.sample_frames + acfg.window_size - acfg.window_stride
        inputs = dict(
            latents=rng.normal(size=(2, c.latent_frames, 48, 16, 24)),
            text_embeds=rng.normal(size=(2, 16, 128)),
            timesteps=np.array([999.0, 499.0]),
            audio_embeds=rng.normal(size=(2, 2, n_af, 2, 128)))
        if face:
            inputs.update(id_cond=rng.normal(size=(2, 2, 64)),
                          id_vit_hidden=rng.normal(size=(2, 2, 5, 17, 64)))
        outs = []
        with torch.inference_mode():
            for model, dev in ((ref, "cpu"), (gpu, "cuda")):
                t = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in inputs.items()}
                rope = model.rope(16 * 8, 24 * 8, c.latent_frames, device=dev)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    _reset_launches()
                out, routing = model.apply(t.pop("latents"), t.pop("text_embeds"),
                                           t.pop("timesteps"), rope, **t)
                if dev == "cuda" and face:
                    torch.cuda.synchronize()
                    launches.update(_read_launches())
                outs.append((out.float().cpu(), None if routing is None else routing.float().cpu()))
        # tol: bf16 activations and weights through 2 blocks against fp32
        scale = float(outs[0][0].abs().max())
        err, rel, step_ok = _compare(outs[1][0], outs[0][0], 0.05 * scale, 0.05)
        what = ("fully conditioned (face + audio, 12 x 64 heads, router 4 x 128, "
                "16 + 288 tokens, 3 frames)" if face else "audio-only (dim 256, 16 + 288 tokens)")
        line = (f"reduced step {what}: cuda-bf16 vs cpu-fp32 max_abs_err={err:.3e} "
                f"(ref max {scale:.3e}) tol=|d|<={0.05 * scale:.3e}+0.05*|ref|")
        if face:
            # tol: routing in [0, 1] through the bf16 router (logit rounded to bf16)
            r_err = float((outs[1][1] - outs[0][1]).abs().max())
            r_ok = bool(outs[1][1].isfinite().all()) and r_err <= 0.05
            line += (f"; routing {tuple(outs[0][1].shape)} max_abs_err={r_err:.3e} tol=0.05 "
                     f"{'ok' if r_ok else 'FAILED'}; launches "
                     + " ".join(f"{k}={v}" for k, v in launches.items()))
            # every kernel of this path ran (B5 needs >= 8 frames: B5' here)
            ran = all(launches[k] > 0 for k in ("B1", "B2", "B3", "B4", "B5'", "B6"))
            step_ok &= r_ok and ran and launches["B5"] == 0
        print(f"{line} {'ok' if step_ok else 'FAILED'}", flush=True)
        ok &= step_ok
    return ok


def train_launches(dit, micro_batches: int) -> dict:
    """Each kernel's launches over `micro_batches` forward + backward passes
    of `Trainer.loss_and_metrics` (two audio tracks; face + audio unless the
    DiT's face path is off), from the DiT's configuration.  Per
    micro-batch, with per-group checkpointing a group's face injection and
    audio layers run forward twice (the forward and the group's recompute)
    and with the nested policy each block three times (and the block's own
    recompute); every backward runs once.
      blocks: 2 x B10 fwd per block forward and 2 x B10 bwd per block (an
        inner width that is a multiple of 128, else the plain math); the
        attention is B7 (forward, backward) when the heads pair in 128
        lanes, else B11 forward and B12 + B13 backward;
      face layer: B2; per STAB: B7 (spatial, when H*W >= 1024; else the
        plain attention), B5 + B8 (temporal, T >= 8; else B5' and the plain
        vjp), B4 (multi-ID); fused LayerNorms (B6 forward, B9 backward):
        perceiver 2, router norms 2, trunk 1, 4 per STAB;
      audio layer: B3 and the norm_q LayerNorm (B6, B9; a width that is a
        multiple of 128, else the plain math);
      once: the audio projection's LayerNorm (B6, no backward: frozen)."""
    c, r, a = dit.cfg, dit.router_cfg, dit.audio_cfg
    t, h, w = c.latent_grid
    g_mult = 2 if c.remat else 1
    b_mult = 3 if c.remat and c.remat_policy == "nested" else g_mult
    n_ca = c.num_ca if c.is_train_face else 0
    n_st = r.num_attention_layers
    stabs = n_ca * n_st
    spatial = stabs if h * w >= 1024 else 0
    temporal = t >= 8
    face_ln = n_ca * (2 + 2 + 1 + 4 * n_st)
    n_audio = a.num_layers if c.is_train_audio else 0
    audio_ln = n_audio if a.dim % 128 == 0 else 0
    paired = c.num_attention_heads % max(1, 128 // c.attention_head_dim) == 0
    flat, layout = (c.num_layers, 0) if paired else (0, c.num_layers)
    hln = c.num_layers if c.inner_dim % 128 == 0 else 0   # B10 takes rows of 128k
    per = {"B1": 0, "B2": n_ca * g_mult, "B3": n_audio * g_mult, "B4": stabs * g_mult,
           "B5": stabs * g_mult if temporal else 0, "B5'": 0 if temporal else stabs * g_mult,
           "B6": (audio_ln + face_ln) * g_mult + int(n_audio > 0 and a.audio_dim % 128 == 0),
           "B7 fwd": flat * b_mult + spatial * g_mult, "B7 bwd": flat + spatial,
           "B8": stabs if temporal else 0, "B9": audio_ln + face_ln,
           "B10 fwd": 2 * hln * b_mult, "B10 bwd": 2 * hln,
           "B11": layout * b_mult, "B12+B13": layout, "B14": 0, "B2c": 0, "B2h": 0}
    return {k: v * micro_batches for k, v in per.items()}


def _train_batch(dit, b: int, gen, dev, vit_tokens: int = 577):
    """A batch of `prepare_batch`'s schema on `dev` from `gen`: noise, image
    (first frame) and background latents, text, the face inputs
    (`id_cond`, `id_vit_hidden`), 2 audio tracks and the mute fixture, the
    identity matrix as the audio-face map, teacher routings from a
    left/right two-person mask (clean; noisy = clean + 0.1 N(0, 1) clipped)
    and a dense face mask at latent resolution."""
    import torch

    c, a, lf = dit.cfg, dit.audio_cfg, dit.lfe_cfg
    t, gh, gw = c.latent_grid
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    lat = lambda: rnd(b, t, c.out_channels, c.sample_height, c.sample_width)
    image = torch.zeros(b, t, c.out_channels, c.sample_height, c.sample_width, device=dev)
    image[:, :1] = rnd(b, 1, c.out_channels, c.sample_height, c.sample_width)
    col = torch.arange(gw, device=dev)
    left = (col < gw // 2).float().expand(t, gh, gw)
    right = (col > gw // 2).float().expand(t, gh, gw)
    clean = torch.stack([left, right], -1).reshape(1, t * gh * gw, 2).repeat(b, 1, 1)
    dense = torch.zeros(b, t, c.sample_height, c.sample_width, device=dev)
    hh, ww = c.sample_height, c.sample_width
    dense[..., hh // 6:hh // 2, ww // 10:ww * 2 // 5] = 1.0
    dense[..., hh // 6:hh // 2, ww * 3 // 5:ww * 9 // 10] = 1.0
    n_af = c.sample_frames + a.window_size - a.window_stride
    batch = dict(
        video_latents=lat(), image_latents=image, bg_latents=lat(),
        prompt_embeds=rnd(b, c.max_text_seq_length, c.text_embed_dim),
        id_cond=rnd(b, c.num_ids, lf.id_embed_dim),
        id_vit_hidden=rnd(b, c.num_ids, lf.num_scales, vit_tokens, lf.vit_dim),
        audio_embeds=rnd(b, 2, n_af, a.blocks, a.audio_dim),
        mute_embeds=rnd(n_af, a.blocks, a.audio_dim),
        af_matrix=torch.eye(c.num_ids, device=dev)[None].repeat(b, 1, 1),
        teacher_clean=clean, teacher_noisy=(clean + 0.1 * rnd(*clean.shape)).clamp(0, 1),
        dense_mask=dense)
    if c.in_channels < 3 * c.out_channels:
        del batch["bg_latents"]
    return batch


def reduced_train_phase(launches: dict, unpaired: bool = False) -> bool:
    """One micro-batch of `Trainer.loss_and_metrics` forward and backward at
    reduced widths on the card (kernels, bf16, nested per-group
    checkpointing) against the same weights and draws on the CPU (plain
    versions, fp32): the loss, each metric and each trainable gradient;
    fills `launches`.
      phase 3b: 2 layers, dim 768 (12 x 64 heads), face + audio, 8 latent
        frames so B8 runs, 16 + 1024 joint tokens so the blocks' attention
        is B7 at a realistic length;
      phase 3c (`unpaired`): the same with 15 x 64 heads (dim 960), whose
        heads do not pair in 128 lanes, so the blocks' attention is B11
        forward and B12 + B13 backward on the [B, S, H, D] view.  Audio
        only: with 64-wide heads an odd head count fixes the LFE output and
        the router width at 2/3 of 960 = 640 = 5 perceiver heads of 128,
        so the router's feat_dim is 32 x 5 = 160, which neither B4 (a power
        of two) nor B5 (64-wide heads) takes."""
    import torch
    from bindyouravatar_tpu_torch.config import (AudioConfig, DiTConfig, LFEConfig,
                                                 RouterConfig, SchedulerConfig, TrainConfig)
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.ops.scheduler import Schedule
    from bindyouravatar_tpu_torch.training.trainer import Trainer

    heads = 15 if unpaired else 12
    base = dict(num_attention_heads=heads, attention_head_dim=64, in_channels=48,
                out_channels=16, time_embed_dim=64, text_embed_dim=128, num_layers=2,
                sample_width=32, sample_height=16, sample_frames=29, max_text_seq_length=16,
                lora_rank=8, lora_alpha=8.0, is_train_face=not unpaired)
    sub = (AudioConfig(dim=heads * 64, audio_dim=128, num_attention_heads=heads,
                       attention_head_dim=64, num_layers=2, blocks=2, intermediate_dim=64,
                       context_tokens=32),
           RouterConfig(num_layers=1, q_k_dim=512, num_heads=4, num_id_token=32, attn_heads=2),
           LFEConfig(dim=128, depth=5, dim_head=64, heads=2, num_id_token=2, num_queries=32,
                     output_dim=512, id_embed_dim=64, vit_dim=64))
    gen = torch.Generator().manual_seed(11)
    ref = DiT.create(DiTConfig(dtype=torch.float32, **base), *sub, device="cpu", generator=gen)
    with torch.no_grad():            # LoRA B off zero, so LoRA A takes gradients too
        for blk in ref.blocks:
            for name in ("to_q_lora_B", "to_k_lora_B"):
                getattr(blk.attn1, name).normal_(0.0, 0.02, generator=gen)
    gpu = DiT.create(DiTConfig(dtype=torch.bfloat16, remat=True, remat_policy="nested", **base),
                     *sub, device="cuda")
    gpu.load_state_dict(ref.state_dict())
    tcfg = TrainConfig(grad_accum_steps=1)
    trainers = [Trainer(m, Schedule.create(SchedulerConfig()), tcfg) for m in (ref, gpu)]
    for tr in trainers:
        tr.init_state()
    batch = _train_batch(ref, 1, gen, "cpu", vit_tokens=17)
    if unpaired:                      # no face path: no face inputs, no teacher routings
        for key in ("id_cond", "id_vit_hidden", "teacher_clean", "teacher_noisy"):
            del batch[key]
    draws = trainers[0].draw(batch, gen)
    # keep the teacher mask (its dropout, p = 0.2, would zero the injected
    # routing and with it every perceiver gradient), so those are compared
    draws["keep_mask"][:] = True
    to_gpu = lambda d: {k: None if v is None else v.cuda() for k, v in d.items()}
    grads_c, m_c = trainers[0].grads_and_metrics(batch, [draws])
    torch.cuda.synchronize()
    _reset_launches()
    grads_g, m_g = trainers[1].grads_and_metrics(to_gpu(batch), [to_gpu(draws)])
    torch.cuda.synchronize()
    launches.update(_read_launches())

    # tol: bf16 activations, and weights rounded to bf16 in every product,
    # through 2 blocks, the router and 2 audio layers against fp32: metrics
    # within 5% (+1e-3), gradients within 10% relative L2 error.  A wrong
    # adjoint or a dropped term gives errors of order 1.  The attention key
    # biases are left out: their true gradient is 0 (softmax is invariant
    # to them), so both sides hold rounding noise.
    ok = True
    m_err = {k: abs(float(m_g[k]) - float(m_c[k])) for k in m_c}
    m_ok = all(m_err[k] <= 1e-3 + 0.05 * abs(float(m_c[k])) for k in m_c)
    g_err = {}
    for k, gc in grads_c.items():
        if k.endswith("to_k.bias"):
            continue
        norm = float(gc.norm())
        diff = float((grads_g[k].float().cpu() - gc).norm())
        g_err[k] = diff / norm if norm > 0 else diff
    worst = sorted(g_err.items(), key=lambda kv: -kv[1])[:3]
    g_ok = all(e <= 0.1 for e in g_err.values())
    want = train_launches(gpu, 1)
    ran = all(launches[k] > 0 for k in (("B11", "B12+B13") if unpaired else ("B7 fwd",)))
    counts_ok = all(launches[k] == want[k] for k in want) and ran
    ok = m_ok and g_ok and counts_ok
    what = ("audio only, 2 layers, 15 x 64 heads (unpaired), 16 + 1024 tokens" if unpaired
            else "face + audio, 2 layers, 12 x 64 heads, 16 + 1024 tokens")
    print(f"reduced train step ({what}, 8 frames, LoRA r8): cuda-bf16 vs cpu-fp32 loss "
          f"{float(m_g['loss']):.5f} / {float(m_c['loss']):.5f}; metrics max |d| "
          + " ".join(f"{k}={v:.2e}" for k, v in m_err.items())
          + f" tol=1e-3+0.05*|ref| {'ok' if m_ok else 'FAILED'}; {len(g_err)} trainable "
          f"gradients, worst relative L2 " + " ".join(f"{k}={v:.3e}" for k, v in worst)
          + f" tol=0.1 {'ok' if g_ok else 'FAILED'}; launches "
          + " ".join(f"{k}={launches[k]} (want {want[k]})" for k in want)
          + f" {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def serving_phase(args, launches: dict) -> bool:
    """Face + audio requests and one audio-only request through the port's
    InferenceServer on one fully conditioned DiT at the 5B geometry; fills
    `launches` with each kernel's count over the run."""
    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.models.vae import CausalVAE
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
    from bindyouravatar_tpu_torch.serving import GenerationRequest, InferenceServer

    dev = torch.device("cuda")
    bf = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(args.seed)
    dit = DiT.create(DiTConfig(is_train_face=True, is_train_audio=True, dtype=bf,
                               param_dtype=bf), device=dev, generator=gen)
    vae = CausalVAE.create(VAEConfig(param_dtype=bf), device=dev, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    n_face = sum(p.numel() for name in ("lfe", "perceivers", "router_norms", "router_layers",
                                        "router_trunk") for p in getattr(dit, name).parameters())
    print(f"model: DiT {n_params / 1e9:.3f}B params ({dit.cfg.num_layers} layers; face path "
          f"{n_face / 1e9:.3f}B), VAE {sum(p.numel() for p in vae.parameters()) / 1e6:.1f}M, "
          f"bf16, drawn on the card in {time.perf_counter() - t0:.1f} s; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    pcfg = PipelineConfig(num_inference_steps=args.steps, decode_temporal_chunk=4)
    pipe = BindYourAvatarPipeline.create(dit, vae, pcfg)
    c, a, lf = dit.cfg, dit.audio_cfg, dit.lfe_cfg
    n_af = pcfg.num_frames + a.window_size - a.window_stride
    reqs = []
    for i in range(args.requests + 1):
        face = i < args.requests              # the last request is audio-only
        rng = np.random.default_rng(args.seed + 1 + i)
        f32 = lambda *shape, fn=rng.normal: fn(size=shape).astype(np.float32)
        cond = dict(id_cond=f32(1, c.num_ids, lf.id_embed_dim),
                    id_vit_hidden=f32(1, c.num_ids, lf.num_scales, 577, lf.vit_dim)) if face else {}
        reqs.append(GenerationRequest(
            prompt_embeds=f32(1, c.max_text_seq_length, c.text_embed_dim),
            image=rng.uniform(-1, 1, (1, 1, 3, pcfg.height, pcfg.width)).astype(np.float32),
            audio_embeds=f32(1, 2, n_af, a.blocks, a.audio_dim),
            seed=args.seed + i, request_id=f"r{i}{' face+audio' if face else ' audio-only'}",
            **cond))

    server = InferenceServer(pipe, dev)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        results = [f.result(timeout=1200) for f in [server.submit(r) for r in reqs]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.update(_read_launches())
    finally:
        server.close()
    peak = torch.cuda.max_memory_allocated() / 2**30

    ok = True
    want_shape = (1, pcfg.num_frames, 3, pcfg.height, pcfg.width)
    for r in results:
        shape_ok = tuple(r.video.shape) == want_shape
        finite = bool(np.isfinite(r.video).all())
        ok &= shape_ok and finite
        stages = " ".join(f"{k}={v:.3f}" for k, v in r.timings.items())
        print(f"request {r.request_id}: video {tuple(r.video.shape)} "
              f"{'ok' if shape_ok else 'WRONG SHAPE'} finite={finite} "
              f"range=[{float(r.video.min()):.3f}, {float(r.video.max()):.3f}] {stages}", flush=True)
    # per batch-2 CFG forward: face + audio runs B1 42 (blocks) + 4 per face
    # layer (STAB spatial), B2 1 and B4, B5 4 per face layer, B3 42, B6 42
    # (audio norm_q) + 21 per face layer; audio-only B1 = B3 = B6 = 42; plus
    # one AudioProjModel B6 per clip
    per = 2 if pcfg.cfg_microbatch else 1
    fwd_face, fwd_audio = args.steps * args.requests * per, args.steps * per
    n_ca, n_st = c.num_ca, dit.router_cfg.num_attention_layers
    face_b6 = 2 + 2 + 1 + 4 * n_st                 # perceiver, router norms, trunk, STABs
    want = {"B1": c.num_layers * (fwd_face + fwd_audio) + n_ca * n_st * fwd_face,
            "B2": n_ca * fwd_face, "B3": a.num_layers * (fwd_face + fwd_audio),
            "B4": n_ca * n_st * fwd_face, "B5": n_ca * n_st * fwd_face, "B5'": 0,
            "B6": a.num_layers * (fwd_face + fwd_audio) + n_ca * face_b6 * fwd_face
            + len(reqs), **{k: 0 for k in TRAIN_KERNELS + LAYOUT_KERNELS}}   # no backward
    counts_ok = launches == want
    ok &= counts_ok
    print(f"serving: {args.requests} face + audio and 1 audio-only requests x {args.steps} steps "
          f"in {wall:.2f} s wall, peak memory {peak:.2f} GiB; launches "
          + " ".join(f"{k}={launches[k]} (want {want[k]})" for k in want)
          + f" {'ok' if counts_ok else 'FAILED'}", flush=True)
    return ok


def _fingerprint(t) -> tuple:
    """An exact, order-independent fingerprint of a tensor's bits (two int64
    sums over its 32- or 16-bit words; wrap-around is deterministic)."""
    import torch

    w = t.detach().contiguous()
    w = w.view(torch.int32 if w.element_size() == 4 else torch.int16).long()
    return int(w.sum()), int((w * (w & 0xFFFF)).sum())


def train_phase(args, launches: dict) -> bool:
    """`args.train_steps` optimizer steps of `Trainer.train_step` (2
    micro-batches each, batch 1 per micro-batch) on the repo's default
    configuration at full width: `DiTConfig(lora_rank=128, remat=True,
    remat_policy="nested")` (42 layers unless `--train-layers` cuts depth,
    dim 3072, 226 + 17,550 tokens, face + audio), fp32 weights drawn on the
    card from a seed, bf16 compute.  Checks finite loss and metrics, moved
    trainable and bit-identical frozen tensors, and each kernel's launch
    count; fills `launches`."""
    import gc

    import torch
    from bindyouravatar_tpu_torch.config import DiTConfig, SchedulerConfig, TrainConfig
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.ops.scheduler import Schedule
    from bindyouravatar_tpu_torch.training.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(args.seed + 100)
    cfg = DiTConfig(lora_rank=128, remat=True, remat_policy="nested",
                    num_layers=args.train_layers)
    dit = DiT.create(cfg, device=dev, generator=gen)
    tr = Trainer(dit, Schedule.create(SchedulerConfig()), TrainConfig(lr_warmup_steps=1))
    state = tr.init_state()
    batch = _train_batch(dit, tr.cfg.grad_accum_steps, gen, dev)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in tr.trainable.values())
    n_all = sum(p.numel() for p in dit.parameters())
    print(f"train model: DiT {n_all / 1e9:.3f}B params ({cfg.num_layers} layers"
          f"{'' if cfg.num_layers == 42 else ', depth cut from 42'}), trainable "
          f"{n_train / 1e9:.3f}B in {len(tr.trainable)} tensors, fp32 weights drawn on the card "
          f"in {time.perf_counter() - t0:.1f} s; weights + AdamW state "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    before_t = {k: _fingerprint(p) for k, p in tr.trainable.items()}
    before_f = {k: _fingerprint(p) for k, p in tr.frozen.items()}

    ok = True
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    gen_step = torch.Generator(dev).manual_seed(args.seed + 200)
    accum = tr.cfg.grad_accum_steps
    for i in range(args.train_steps):
        t0 = time.perf_counter()
        # Trainer.draw per micro-batch, as train_step would, so they can be shown
        draws = [tr.draw({"video_latents": batch["video_latents"][j:j + 1]}, gen_step)
                 for j in range(accum)]
        shown = "; ".join(f"t={int(d['t'][0])} keep image/teacher mask="
                          f"{bool(d['keep_img'].all())}/{bool(d['keep_mask'].all())} "
                          f"mask loss={bool(d['use_mask_loss'])}" for d in draws)
        state, m = tr.train_step(state, batch, draws=draws)
        vals = {k: float(v) for k, v in m.items()}
        wall = time.perf_counter() - t0
        finite = all(math.isfinite(v) for v in vals.values())
        ok &= finite
        print(f"train step {i + 1}: {wall:.2f} s wall ({accum} micro-batches: {shown}; "
              f"lr {tr.lr(state.count - 1):.2e}); "
              + " ".join(f"{k}={v:.5g}" for k, v in vals.items())
              + f" finite={finite}", flush=True)
    torch.cuda.synchronize()
    launches.update(_read_launches())
    peak = torch.cuda.max_memory_allocated() / 2**30

    moved = sum(_fingerprint(p) != before_t[k] for k, p in tr.trainable.items())
    frozen_same = all(_fingerprint(p) == before_f[k] for k, p in tr.frozen.items())
    # every trainable that received a gradient moves.  AdamW's first moment
    # is zero exactly where every gradient was: the mute tokens (unused with
    # two audio tracks), LoRA A while B is zero (peft's init; dL/dA = x^T g
    # B^T), and the perceivers in a step whose micro-batches all drew the
    # teacher-mask dropout (p = 0.2: the injected routing is then zero).
    # There weight decay alone (lr * 1e-4 * p) is under half an fp32 ulp.
    # The attention key biases are the other exception: their true gradient
    # is 0 (softmax is invariant to them), so they hold rounding noise that
    # clipping leaves below an ulp's worth of update.
    still = [k for k, p in tr.trainable.items() if _fingerprint(p) == before_t[k]]
    with torch.no_grad():
        no_grad = [k for k in still if not bool(state.mu[k].any())]
    still_ok = all(k in no_grad or k.endswith("to_k.bias") for k in still)
    want = train_launches(dit, args.train_steps * tr.cfg.grad_accum_steps)
    counts_ok = all(launches[k] == want[k] for k in want)
    ok &= still_ok and frozen_same and counts_ok
    print(f"train: {args.train_steps} steps; trainable moved {moved}/{len(tr.trainable)} "
          f"(unmoved: {len(no_grad)} with no gradient in any step, of them "
          f"{sum(k.endswith('lora_A') for k in no_grad)} LoRA A and "
          f"{sum(k.startswith('perceivers.') for k in no_grad)} perceiver tensors; "
          f"{sum(k.endswith('to_k.bias') and k not in no_grad for k in still)} key biases; "
          f"others: {[k for k in still if k not in no_grad and not k.endswith('to_k.bias')]}) "
          f"{'ok' if still_ok else 'FAILED'}; frozen "
          f"{len(tr.frozen)} tensors bit-identical={frozen_same}; peak memory {peak:.2f} GiB; "
          "launches " + " ".join(f"{k}={launches[k]} (want {want[k]})" for k in want)
          + f" {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2, help="denoise steps per request")
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-steps", type=int, default=2, help="optimizer steps of phase 5")
    p.add_argument("--train-layers", type=int, default=42,
                   help="depth of the phase-5 DiT (widths stay full)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device: this smoke runs only on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from bindyouravatar_tpu_torch.ops import _build
    except ImportError as e:
        return _fail(f"the port package is not beside this script: {e}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else "?"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    try:
        lib = _build.build_cuda()
        _build.cuda_lib()
        _build.import_triton()
    except (RuntimeError, OSError, ImportError) as e:
        return _fail(f"kernel build: {e}")
    print(f"build: {lib.name} (nvcc sm_90a, B1 + B2 + B3 + B5 + B7 forward + B8 + B11 + B14 + "
          f"B2c + B2h, the fused flash backward of B7 and B12 + B13) and triton import in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = [ln for ln in (lib.parent / "nvcc.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    for line in ptxas:
        print(f"  ptxas: {line.strip()}", flush=True)

    results, launches, reduced_launches, train_launches_ = {}, {}, {}, {}
    unpaired_launches, entry_launches = {}, {}
    ok = kernel_phase(results)
    ok &= reduced_step_phase(reduced_launches)
    ok &= reduced_train_phase({})
    ok &= reduced_train_phase(unpaired_launches, unpaired=True)
    ok &= entry_point_phase(entry_launches)
    if args.requests > 0:
        ok &= serving_phase(args, launches)
    else:
        ok = False
        print("serving phase skipped (--requests 0): no launch counts", flush=True)
    if args.train_steps > 0:
        ok &= train_phase(args, train_launches_)
    else:
        ok = False
        print("train phase skipped (--train-steps 0): no launch counts", flush=True)
    if not ok:
        return _fail("a phase failed")

    # B5' runs only below 8 latent frames: its launches are those of the
    # reduced fully conditioned step (3 frames), every other kernel's those
    # of the serving run
    launches["B5'"] = reduced_launches["B5'"]
    # the training kernels' launches are those of the full-width train step;
    # B11 and B12 + B13 run in the unpaired-head train step (phase 3c), B14,
    # B2c and B2h through the entry points (phase 3d)
    for name in TRAIN_KERNELS:
        launches[name] = train_launches_[name]
    for name in ("B11", "B12+B13"):
        launches[name] = unpaired_launches[name]
    for name in ("B14", "B2c", "B2h"):
        launches[name] = entry_launches[name]
    meta = {
        "B1": ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
               "bindyouravatar_tpu/ops/flash_attention.py:592"),
        "B2": ("cuda", "bindyouravatar_tpu_torch/csrc/short_kv_attention.cu",
               "bindyouravatar_tpu/ops/short_kv_attention.py:41"),
        "B3": ("cuda", "bindyouravatar_tpu_torch/csrc/short_kv_attention.cu",
               "bindyouravatar_tpu/ops/short_kv_attention.py:177"),
        "B4": ("triton", "bindyouravatar_tpu_torch/ops/_pair_triton.py",
               "bindyouravatar_tpu/ops/packed_attention.py:226"),
        "B5": ("cuda", "bindyouravatar_tpu_torch/csrc/packed_attention.cu",
               "bindyouravatar_tpu/ops/packed_attention.py:139"),
        "B5'": ("cuda", "bindyouravatar_tpu_torch/csrc/packed_attention.cu",
                "bindyouravatar_tpu/ops/packed_attention.py:47"),
        "B6": ("triton", "bindyouravatar_tpu_torch/ops/_ln_triton.py",
               "bindyouravatar_tpu/ops/layernorm.py:26"),
        "B7 fwd": ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
                   "bindyouravatar_tpu/ops/flash_attention.py:352"),
        "B7 bwd": ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention_bwd.cu",
                   "bindyouravatar_tpu/ops/flash_attention.py:1050"),
        "B8": ("cuda", "bindyouravatar_tpu_torch/csrc/packed_attention.cu",
               "bindyouravatar_tpu/ops/packed_attention.py:351"),
        "B9": ("triton", "bindyouravatar_tpu_torch/ops/_ln_triton.py",
               "bindyouravatar_tpu/ops/layernorm.py:199"),
        "B10 fwd": ("triton", "bindyouravatar_tpu_torch/ops/_ln_triton.py",
                    "bindyouravatar_tpu/ops/layernorm.py:272"),
        "B10 bwd": ("triton", "bindyouravatar_tpu_torch/ops/_ln_triton.py",
                    "bindyouravatar_tpu/ops/layernorm.py:285"),
        "B11": ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
                "bindyouravatar_tpu/ops/flash_attention.py:75"),
        "B12+B13": ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention_bwd.cu",
                    "bindyouravatar_tpu/ops/flash_attention.py:919, :981"),
        "B14": ("cuda", "bindyouravatar_tpu_torch/csrc/short_kv_attention.cu",
                "bindyouravatar_tpu/ops/short_kv_attention.py:71"),
        "B2c": ("cuda", "bindyouravatar_tpu_torch/csrc/short_kv_attention.cu",
                "bindyouravatar_tpu/ops/short_kv_attention.py:41"),
        "B2h": ("cuda", "bindyouravatar_tpu_torch/csrc/short_kv_attention.cu",
                "bindyouravatar_tpu/ops/short_kv_attention.py:41"),
    }
    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], **results[name]}
               for name, (route, source, replaces) in meta.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
