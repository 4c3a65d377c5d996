#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py     # 42 layers; serving requests of 2 steps each; 2 optimizer steps
                              # of the Stage-3 train step; the sft launcher: 2 steps, a
                              # checkpoint, a resume and a third step; a 50-step clip; the CLI
                              # (also two-stage); SAM2 and the upscaler
    python3 chip_smoke.py --only-kernels B2,B3,B6   # phase 2 of these kernels only

Phases (one line each; any failure exits non-zero and prints no result):
  1. the card's `nvidia-smi` name and power limit; build every kernel (one
     nvcc per CUDA source, all at once).
  2. each kernel (B1 flash attention, fused and bare; B2 and B3 short-KV
     attention; B4 pair-axis attention; B5 and B5' tiny-sequence attention;
     B6 LayerNorm forward; the training path's B7 flash attention forward and
     backward, B8 tiny-sequence backward, B9 LayerNorm backward, B10
     per-head LayerNorm forward and backward; and the general-layout
     kernels: B11 flash attention forward over [B, H, S, D] / [B, S, H, D]
     (QK-LN + RoPE, RoPE, bare, D = 128), its fused backward B12 + B13 (dq,
     dk, dv in one launch, the kernel B7's backward shares) in both layouts, B14 q-major short-KV attention (combined and
     per identity), B2c and B2h head-major short-KV attention (combined,
     per identity)) against its plain PyTorch version on the card, at the
     serving or train step's shapes and at a ragged shape, with the stated
     tolerance (the flash forward also at S = 1,350 with kv_len = 1,000,
     whole kv tiles past it, and with logits of several hundred, which only
     an online max keeps finite; the short-KV body, B6, B8 and B9 at their
     hazards, untimed: Sq = 1,000 over 3 batches at I = 1, 2, 4, D = 64 and
     128 in both layouts and modes, and combined at [26, 1350, 16, 128], so
     that persistent blocks' shares cross a change of batch; 1,001 rows at
     every B6 and B9 width from 128 to 8192, B9 also at 64 and 5 rows; B8
     at M = 1,001 for S = 8, 13, 16; B8 and B9 run twice, bitwise equal;
     B5 and B5', timed, at M = 1,001 for S = 1, 2, 7, 8, 9, 13, 16 and at
     M = 5, and B5 run twice at its main shape, bitwise equal);
     kernel, plain version and (where one
     PyTorch call computes the same function) that library call timed with
     CUDA events and, kernel and library call, from profiler device records
     (a window that reads less than the bound is printed kernel by kernel
     and taken again), and the bound computed.
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
     points), outputs against the plain versions; flat
     `flash_attention` under grad (B7 forward and backward, q's gradient
     against the plain backward) and the fused QK-LN forms under grad
     (they must raise); exact launch counts.
  4. the port's `InferenceServer` answers 2 face + audio requests and 1
     audio-only request through `pipeline.generate` on one fully
     conditioned DiT at the 5B geometry (dim 3072, 48 x 64 heads, 226 +
     17,550 tokens, 21 face layers with the router, 49 x 480 x 720 video,
     decoded whole) with random weights drawn on the card from a seed;
     then a request streamed in chunks of 4 latent frames (its chunks equal
     `decode(temporal_chunk=4)` of its latents bit for bit; the whole and
     the chunked decode timed), a forced-routing request (equal to a
     direct `generate(routing_forcing=...)` bit for bit, whose
     `return_routing` is [2, 21, 1, 17550, 2] bf16), one request through
     `serve_http` on 127.0.0.1 (equal to the first request's clip), and two
     co-batchable requests on a `batch_max=2` server (one denoise, batch
     size 2); output shape, finiteness and each run's launch counts are
     checked.
  5. 2 optimizer steps (2 micro-batches each) of `Trainer.train_step` on the
     default configuration at full width (LoRA r128, nested per-group
     checkpointing, 42 layers): finite metrics, moved trainable and
     bit-identical frozen tensors, exact launch counts, peak memory.
  5b. the same model, weights and batch: one optimizer step's
     micro-batches (gradients, no update) under remat_policy="save_attn"
     against "nested" with the same draws: loss within 1e-3 relative,
     every trainable gradient within 10% relative L2, exact launch counts
     of both (the joint attention's forward once per block under
     "save_attn"), peak memory and wall of both.
  6. the port's training entry point at the 5B geometry, after phase 5's
     model is freed: `training.sft.main` in this process, `--model_size
     5b --remat_policy nested`, 16 layers with widths full
     (`--driver-layers`; a save at 42 layers writes 32.4 GB of state and
     sub-modules, and the phase saves twice), synthetic 49 x 480 x 720
     clips encoded by the VAE, teacher masks, the driver: 2 optimizer
     steps and a checkpoint into a temporary directory, then `--max_train_steps 3
     --resume latest`: the restored trainable tensors, AdamW moments,
     sampler and generator states equal the saved ones, step 3 runs,
     `metrics.jsonl` holds 3 finite rows, the frozen tensors are
     bit-identical and each run's launch counts are exact; per step the
     `prepare_batch` and step seconds and peak memory, the checkpoint's
     bytes and its save and restore seconds, and the free disk.
  7. after phase 6 frees its model: one face + audio request through the
     `InferenceServer` on a new 42-layer 5B model, `--clip-steps` (50)
     DPM++ steps, guidance 6, 49 x 480 x 720, whole decode, weights and
     conditioning drawn on the card: finite [1, 49, 3, 480, 720], exact
     launch counts, `prep_s`, `encode_s`, `denoise_s`, `decode_s`,
     `compute_s`, seconds a step, peak memory.
  7b. the CLI (`infer.run(infer.get_args([...]))`) at `--model_size 5b
     --num_layers 42 --num_inference_steps 2`, two audio tracks at the 5B
     contract and the mute track as .pt, prompt embeddings as .npy: the
     clip, its meta line and the launch counts; then the mp4 export
     (`main`'s), which writes the file or, without OpenCV, must raise.
  7c. the CLI's `run` as 7b, but from two face images
     (`--img_file_path assets/faces/000_0.png assets/faces/000_1.png`)
     through `--retinaface_checkpoint`, `--bisenet_checkpoint` and
     `--arcface_checkpoint` (files written with `torch.save` of drawn port
     networks, which carry the reference checkpoints' names): `id_cond`
     [1, 2, 1280] and `id_vit_hidden` [1, 2, 5, 577, 1024] reach the DiT
     with the composite canvas, face + audio launch counts, the peak
     within 1 GiB of 7b's.  `--t5_dir` is not run: it needs a tokenizer
     directory, which the card's machine lacks (phase 8 runs T5 itself).
  7d. the CLI's `main` with `--two_stage_generate` from 7c's inputs: SAM2
     from a sam2.1-keyed `sam2.1_hiera_large` checkpoint drawn on the card
     (`$BYA_SAM2_CKPT`), the mask tool in the process over stage 1's mp4
     (49 frames per identity), stage 2 forced on the same pipeline; launch
     counts twice 7c's, the mp4, finite clips; `main`'s wall, the tool's
     seconds, the peak beside 7c's.
  8. the conditioning encoders at full size, bf16 weights drawn on the
     card: T5-XXL's encoder on 2 x 226 tokens, EVA02-CLIP-L-336, IR-100,
     RetinaFace-R50 on a 480 x 720 image, BiSeNet at 512: shapes,
     finiteness, ms and peak; at 2 blocks (T5, EVA-CLIP) or whole (the
     CNNs) against the CPU in fp32 on the same weights.  None of them
     launches a kernel: JAX's twins reach no Pallas kernel.
  9. SAM2 at `sam2.1_hiera_large` (image 1024) and RRDBNet at
     `RealESRGAN_x4plus`, fp32 weights drawn on the card: the image
     encoder's ms a frame, `propagate_in_video` over 49 x 480 x 720 with 2
     objects (the bank full at 7 memories + 16 pointers), `tiled_scale`
     (512 tiles, overlap 32) on one 480 x 720 frame, peaks; each against
     the CPU in fp32 at reduced depth.  Neither launches a kernel: JAX's
     SAM2 and RRDBNet reach no Pallas kernel.
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


def kernel_phase(results: dict, only=None) -> bool:
    """Kernels vs plain versions at the serving path's shapes and at one
    ragged shape each; records the serving-shape numbers in `results`.
    `only`: the kernel names to run (a name or its first word, "B7" for
    both of B7's rows); all when None."""
    import torch
    import torch.nn.functional as F
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import layernorm as ln
    from bindyouravatar_tpu_torch.ops import packed_attention as pa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv
    from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed
    from bindyouravatar_tpu_torch.profile_step import kernel_ms, kernel_records

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1234)
    rnd = lambda *shape, std=1.0, mean=0.0: (
        torch.randn(shape, generator=gen, device=dev) * std + mean)
    bf = torch.bfloat16
    ok_all = True

    fmt = lambda ms: "none" if ms is None else f"{ms:.4f}"

    def pick(rows, names=None):
        """The rows to run: all of them when one of `names` is asked for,
        or (names None) those whose first field names a kernel asked for
        (names match by their first word)."""
        wanted = lambda n: only is None or n.split()[0] in {o.split()[0] for o in only}
        if names is None:
            return [r for r in rows if wanted(r[0])]
        return rows if any(wanted(n) for n in names) else ()

    def report(name, tag, got, want, atol, rtol, kern, plain, runs, library=None, work=None):
        """Compare, time kernel / plain / library call; `work` = (bytes,
        flops, peak kind) of the call for its bound.  The kernel and the
        library call are timed twice: CUDA events around the call (`ms`,
        `library_ms`) and the kernels' own time from profiler device
        records (`kernel_ms`: `kernel_records_ms`, `library_records_ms`),
        which leaves out the host time that events around a
        sub-millisecond call take in while the card waits."""
        nonlocal ok_all
        err, rel, ok = _compare(got, want, atol, rtol)
        ms, plain_ms = _time_ms(kern, runs), _time_ms(plain, max(1, runs // 2))
        lib_ms = None if library is None else _time_ms(library, runs)
        bound_ms, bound_by = _bound(*work) if work is not None else (None, None)

        def records(fn, what):
            """kernel_ms over at least 10 calls (a short window can miss
            records).  A window with no record, or with less device time
            than the bound allows (a missed record can round a kernel's
            launches per call down), is printed kernel by kernel and taken
            again 50 calls long; the second reading stands (inputs that fit
            in L2 can beat the bound, which counts HBM bytes)."""
            for n in (max(runs, 10), 50):
                recs = kernel_records(fn, n)
                rec = kernel_ms(fn, n, recs)
                if rec is not None and (bound_ms is None or rec >= bound_ms):
                    break
                seen = "; ".join(f"{k[:70]} x{c} median {m:.4f}" for k, (c, m) in recs.items())
                print(f"  {what} records of {name} {tag}, {n} calls: {fmt(rec)} ms against "
                      f"the bound {fmt(bound_ms)}: {seen or 'no record'}", flush=True)
            return rec

        rec_ms = records(kern, "kernel")
        lib_rec_ms = None if library is None else records(library, "library")
        ok_all &= ok
        extra = "" if bound_ms is None else f" bound_ms={bound_ms:.4f} ({bound_by})"
        print(f"kernel {name} {tag}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"tol=|d|<={atol}+{rtol}*|ref| {'ok' if ok else 'FAILED'} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}{extra} library_ms={fmt(lib_ms)} "
              f"kernel_records_ms={fmt(rec_ms)} library_records_ms={fmt(lib_rec_ms)}",
              flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by, kernel_records_ms=rec_ms,
                    library_records_ms=lib_rec_ms)

    def check(name, tag, got, want, atol, rtol):
        """Compare only (the hazard shapes, which are not timed)."""
        nonlocal ok_all
        err, rel, ok = _compare(got, want, atol, rtol)
        ok_all &= ok
        print(f"kernel {name} {tag}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"tol=|d|<={atol}+{rtol}*|ref| {'ok' if ok else 'FAILED'}", flush=True)

    def check_ok(name, tag, ok):
        """A check that is true or false (a bitwise repeat)."""
        nonlocal ok_all
        ok_all &= ok
        print(f"kernel {name} {tag}: {'ok' if ok else 'FAILED'}", flush=True)

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
    # attention at [52, 1350, 8*64], at a ragged S=777, at S=1350 with
    # kv_len=1000 (a part-masked kv tile, whole tiles past kv_len never
    # read) and with q and k scaled by 8 (logits of several hundred, so only
    # an online max keeps 2^s finite).
    # tol: both sides round LN/RoPE outputs and p to bf16; behind LN/RoPE the
    # kernel also rounds the scaled q (one more bf16 ulp, ~0.4% of a logit);
    # the bare calls scale the fp32 scores, as the plain version does.
    # library: SDPA computes the bare function only (no QK-LN, no RoPE).
    for tag, b, s, h, text_len, grid, kv_len, mag in pick((
            ("slice[2,17776,3072]", 2, 17776, 48, 226, (13, 30, 45), None, 1.0),
            ("ragged[1,1000,512] kv_len=937", 1, 1000, 8, 10, (3, 18, 18), 937, 1.0),
            ("bare[52,1350,512] no LN/RoPE", 52, 1350, 8, 0, None, None, 1.0),
            ("ragged[2,777,256] no LN/RoPE", 2, 777, 4, 0, None, None, 1.0),
            ("ragged[2,1350,512] kv_len=1000 no LN/RoPE", 2, 1350, 8, 0, None, 1000, 1.0),
            ("large[4,1350,512] q,k x8 no LN/RoPE", 4, 1350, 8, 0, None, None, 8.0)), ["B1"]):
        q, k, v = (rnd(b, s, h * 64, std=mag if i < 2 else 1.0).to(bf) for i in range(3))
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
    for tag, b, sq in pick((("slice[2,17550,2048] I=2 K=32", 2, 17550),
                            ("ragged[1,1000,2048] I=2 K=32", 1, 1000)), ["B2"]):
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
    for tag, g, sq, w_uniform in pick((("slice[26,1350,3072] w=0.5", 26, 1350, True),
                                       ("slice[26,1350,3072] w~U(0,1)", 26, 1350, False),
                                       ("ragged[3,1000,3072]", 3, 1000, False)), ["B3"]):
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
    for tag, b, m in pick((("slice[2,2,17550,512]", 2, 17550), ("ragged[1,2,1001,512]", 1, 1001)),
                          ["B4"]):
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
    # Then every kind of tile the kernel makes: at M = 1,001 S = 1, 2, 7
    # (16 / S items packed in a tile, the last tile part empty) and 8, 9, 16
    # (one item a tile: 8 or 7 pad rows, none); and M = 5 (fewer tiles than
    # resident warps) at S = 13 and 3.
    # tol: both sides round p to bf16; fp32 sums in another order.
    # library: SDPA on a [M, 8, S, 64] copy (permuted before timing).
    b5_rows = [("B5", "slice[5400,13,512]", 5400, 13), ("B5", "ragged[1001,13,512]", 1001, 13),
               ("B5'", "slice[5400,3,512]", 5400, 3), ("B5'", "slice[5400,2,512]", 5400, 2)]
    b5_rows += [("B5" if s >= 8 else "B5'", f"ragged[1001,{s},512]", 1001, s)
                for s in (1, 2, 7, 8, 9, 16)]
    b5_rows += [("B5", "tiny[5,13,512]", 5, 13), ("B5'", "tiny[5,3,512]", 5, 3)]
    for name, tag, m, s in pick(b5_rows):
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
        if tag == "slice[5400,13,512]":
            # no sums across items, so a second call repeats the first bit for bit
            check_ok(name, f"{tag} run twice: bitwise equal", torch.equal(got, kern()))

    # --- B6: audio norm_q rows [2*17550, 3072], AudioProjModel [2*2*13*32, 768];
    # the face path's widths: router norms [35100, 2048], STAB/trunk [70200, 512]
    # tol: one bf16 rounding of the same fp32 value, summed in another order
    # library: F.layer_norm (affine cast to bf16 before timing)
    for tag, rows, d in pick((("slice[35100,3072]", 35100, 3072), ("slice[1664,768]", 1664, 768),
                              ("slice[35100,2048]", 35100, 2048), ("slice[70200,512]", 70200, 512),
                              ("ragged[1001,768]", 1001, 768)), ["B6"]):
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
    # B6 hazards, not timed: a ragged row count (1,001) at every width above,
    # at the wrapper's extremes (D = 128, 8192) and at widths whose 16-byte
    # chunks do not fill the threads of a row (640, 1152)
    for d in pick((128, 512, 640, 768, 1152, 2048, 3072, 8192), ["B6"]):
        x = rnd(1001, d, std=2.3, mean=0.7).to(bf)
        sc, bi = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1)
        check("B6", f"ragged[1001,{d}]", ln.fused_layernorm(x, sc, bi),
              ln.layernorm_plain(x, sc, bi), 1e-2, 1e-2)

    # --- short-KV hazards (B2, B3, B14, B2c, B2h run one body), not timed:
    # Sq = 1,000 (a ragged last 64-row tile) at I = 1, 2 and 4 identities, D =
    # 64 and 128, q-major and head-major, combined and per identity, through
    # each entry point that takes the case (B3 and B2: their flat entries at
    # D = 64 / 128; B14: q-major; B2c, B2h: head-major); then the combined
    # calls at [26, 1350, 16, 128], I = 2, in both layouts.  A persistent
    # block takes one share of its head's G x 16 tiles (G x 22 at 1,350
    # rows): total / m tiles, m = 132 SMs x blocks per SM / H on the H100,
    # i.e. 8 (D = 64 at I = 1, 2; D = 128 at I = 2, 4), 5 (D = 64 at I = 4),
    # and 16 or 8 (D = 128 at I = 1, by registers).  At G = 3 the shares are
    # 6, 9-10 and 3 tiles, and some start before tile 16 or 32 and end
    # after it: they cross a change of batch, where the block loads the
    # next batch's K/V (at G = 2 every change of batch fell on a share's
    # start).  At [26, 1350] the shares of 71-72 tiles cross three each.
    # tol: as the main shapes.
    def skv_cases(g, sq, h, d, n_id, combined_only=False):
        k, v = (rnd(g, n_id, h, 32, d).to(bf) for _ in range(2))
        w = torch.rand((g, sq, n_id), generator=gen, device=dev).to(bf)
        q_q, q_h = rnd(g, sq, h, d).to(bf), rnd(g, h, sq, d).to(bf)
        cases = [("B14", "combined", skv.short_kv_attention_combined_qmajor, (q_q, k, v, w)),
                 ("B2c", "head-major combined", skv.short_kv_attention_combined,
                  (q_h, k, v, w))]
        if not combined_only:
            cases += [("B14", "per-id", skv.short_kv_attention_qmajor, (q_q, k, v)),
                      ("B2h", "head-major per-id", skv.short_kv_attention, (q_h, k, v))]
            flat = q_q.reshape(g, sq, h * d)
            cases.append(("B3", "flat combined", skv.short_kv_attention_combined_flat,
                          (flat, k, v, w)) if d == 64 else
                         ("B2", "flat per-id", skv.short_kv_attention_flat, (flat, k, v)))
        return pick(cases)

    hazards = [(3, 1000, 48 if d == 64 else 16, d, n_id, False)
               for d in (64, 128) for n_id in (1, 2, 4)] + [(26, 1350, 16, 128, 2, True)]
    for g, sq, h, d, n_id, combined_only in hazards:
        for name, what, fn, args in skv_cases(g, sq, h, d, n_id, combined_only):
            plain = getattr(skv, f"{fn.__name__}_plain")
            check(name, f"ragged {what} [G={g},Sq={sq},H={h},D={d}] I={n_id}",
                  fn(*args, d ** -0.5), plain(*args, d ** -0.5), 1e-2, 2e-2)
    # report() and report_all() clear ok_all themselves
    train_kernel_phase(results, rnd, report, report_all, bhsd, pick, check, check_ok)
    layout_kernel_phase(results, rnd, report, report_all, pick)
    return ok_all


def _rel_compare(got, want, rel: float) -> float:
    """The absolute tolerance `rel` times the reference's largest magnitude
    (for gradients, whose scale depends on the shape)."""
    return rel * float(want.float().abs().max())


def train_kernel_phase(results: dict, rnd, report, report_all, bhsd, pick, check,
                       check_ok) -> None:
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
    for tag, b, s, h, text_len, grid, kv_len in pick((
            ("train[1,17776,3072] rope", 1, 17776, 48, 226, (13, 30, 45), None),
            ("bare[26,1350,512]", 26, 1350, 8, 0, None, None),
            ("ragged[1,1000,512] kv_len=937 rope", 1, 1000, 8, 10, (3, 18, 18), 937),
            ("ragged bare[2,1350,512] kv_len=1000", 2, 1350, 8, 0, None, 1000)),
            ["B7 fwd", "B7 bwd"]):
        q, k, v, do = (rnd(b, s, h * 64).to(bf) for _ in range(4))
        kw = dict(kv_len=kv_len)
        lib_f = lib_b = None
        if grid is not None:
            kw.update(rope=get_3d_rotary_pos_embed(64, ((0, 0), grid[1:]), grid[1:], grid[0],
                                                   device=dev), rope_start=text_len)
        elif kv_len is None:
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
    for tag, m in pick((("train[2700,13,512]", 2700), ("ragged[1001,13,512]", 1001)), ["B8"]):
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
    for name, tag, rows, d in pick((("B9", "train[17550,3072]", 17550, 3072),
                               ("B9", "train[17550,2048]", 17550, 2048),
                               ("B9", "train[35100,512]", 35100, 512),
                               ("B9", "train[64,2048]", 64, 2048),
                               ("B9", "ragged[1001,768]", 1001, 768),
                               ("B10", "train[17776,3072]", 17776, 3072),
                               ("B10", "ragged[1001,512]", 1001, 512))):
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

    # B8 and B9 hazards, not timed; each call is run twice and must repeat
    # itself bit for bit (B9 folds its partial rows in a fixed order, B8
    # has no sums across items).  B8: M = 1,001 (a persistent warp's last
    # items ragged) at S = 8, 13 and 16 (pad rows 8, 3 and 0 of the 16-row
    # tile).  B9: 1,001 rows at every width (D = 640 and 1,152 leave a
    # thread's last chunk empty, 8,192 takes four chunks a thread), and
    # fewer rows than the card holds blocks ([64, 2048], [5, 3072]: a grid
    # of row steps, no block without rows).
    # tol: as the timed rows.
    def check_twice(name, tag, fn, want, rels):
        first, again = fn(), fn()
        for i, (got, ref, rel) in enumerate(zip(first, want, rels)):
            check(name, f"{tag} out{i}", got, ref, _rel_compare(got, ref, rel), rel)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        check_ok(name, f"{tag} run twice: bitwise equal", same)

    for s_ in pick((8, 13, 16), ["B8"]):
        q, k, v, g = (rnd(1001, s_, 512).to(bf) for _ in range(4))
        check_twice("B8", f"ragged[1001,{s_},512]",
                    lambda: pa.tiny_seq_attention_bwd(q, k, v, g, 8, 0.125),
                    pa.tiny_seq_attention_bwd_plain(q, k, v, g, 8, 0.125), (1e-2,) * 3)
    for rows, d in pick([(1001, d) for d in (128, 512, 640, 768, 1152, 2048, 3072, 8192)]
                        + [(64, 2048), (5, 3072)], ["B9"]):
        x = rnd(rows, d, std=2.3, mean=0.7).to(bf)
        g = rnd(rows, d).to(bf)
        sc = rnd(d, std=0.1, mean=1.0)
        check_twice("B9", f"ragged[{rows},{d}]", lambda: ln.layernorm_bwd(x, sc, g),
                    ln.layernorm_bwd_plain(x, sc, g), (1e-2, 1e-3, 1e-3))


def layout_kernel_phase(results: dict, rnd, report, report_all, pick) -> None:
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
              (3, 18, 18), False, 937),
             ("ragged bare bhsd[2,8,1350,64] kv_len=1000", "bhsd", 2, 1350, 8, 64, 0, None,
              False, 1000),
             ("ragged bare D=128 bshd[1,1350,4,128] kv_len=1000", "bshd", 1, 1350, 4, 128, 0,
              None, False, 1000),
             ("large bare bhsd[2,8,1350,64] q,k x8", "bhsd", 2, 1350, 8, 64, 0, None, False,
              None))
    for tag, layout, b, s, h, d, text_len, grid, ln_on, kv_len in pick(cases,
                                                                         ["B11", "B12+B13"]):
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        mag = 8.0 if tag.startswith("large") else 1.0   # logits of several hundred
        q, k, v = (rnd(*shape, std=mag if i < 2 else 1.0).to(bf) for i in range(3))
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
        if ln_on or mag != 1.0:
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
    for name, tag, g, sq, h, d, combine, qmajor in pick((
            ("B14", "combined[26,1350,48,64] I=2 K=32", 26, 1350, 48, 64, True, True),
            ("B14", "per-id[2,17550,16,128] I=2 K=32", 2, 17550, 16, 128, False, True),
            ("B14", "ragged combined[3,1001,48,64]", 3, 1001, 48, 64, True, True),
            ("B2c", "head-major combined[26,48,1350,64] I=2 K=32", 26, 1350, 48, 64, True,
             False),
            ("B2h", "head-major per-id[2,16,17550,128] I=2 K=32", 2, 17550, 16, 128, False,
             False))):
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
    outputs against the plain versions, gradients finite.  Then flat
    `flash_attention` with RoPE under grad, which must take B7 (a tracked
    output, q's gradient against the plain B7 backward), and its fused
    QK-LN forms under grad, flat and bhsd, which must raise.  Fills
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
    # flat attention under grad: the differentiable B7 (forward and
    # backward), as JAX's `_flash_flat`; the fused QK-LN forms, which have
    # no backward, raise instead of returning a detached tensor
    q_f, k_f, v_f = (rnd(1, 17776, 3072).requires_grad_() for _ in range(3))
    do_f = rnd(1, 17776, 3072)
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
    o_f = fa.flash_attention(q_f, k_f, v_f, 48, rope=rope, rope_start=226)
    tracked = o_f.requires_grad and o_f.grad_fn is not None
    dq_f = torch.autograd.grad(o_f, q_f, do_f)[0] if tracked else None
    raised = []
    for fused in (lambda: fa.flash_attention(q_f, k_f, v_f, 48, rope=rope, rope_start=226,
                                             qk_norm=norm),
                  lambda: fa.flash_attention(*qkv, layout="bhsd", qk_norm=norm)):
        try:
            fused()
            raised.append(False)
        except ValueError:
            raised.append(True)
    torch.cuda.synchronize()
    launches.update(_read_launches())
    want = {k: 0 for k in _kernel_fns()}
    want.update({"B7 fwd": 1, "B7 bwd": 1, "B11": 2, "B12+B13": 1, "B14": 2, "B2c": 1,
                 "B2h": 1})
    for (name, _, plain, _), (out, finite) in zip(calls, outs):
        with torch.no_grad():
            ref = plain()
        # tol: as phase 2 (bf16 roundings of the same fp32 values)
        err, _, match = _compare(out, ref, _rel_compare(out, ref, 2e-2), 2e-2)
        ok &= match and finite
        print(f"entry point {name}: output {tuple(out.shape)} max_abs_err={err:.3e} "
              f"gradients finite={finite} {'ok' if match and finite else 'FAILED'}", flush=True)
    grad_ok = tracked and all(raised)
    if tracked:
        with torch.no_grad():
            o_p, lse_p = fa.flash_attention_flat_fwd_plain(q_f, k_f, v_f, 48, rope=rope,
                                                           rope_start=226, block_q=512)
            dq_p = fa.flash_attention_flat_bwd_plain(
                q_f, k_f, v_f, do_f, lse_p, fa.attention_delta(o_p, do_f, 48), 48, rope=rope,
                rope_start=226, block_q=512)[0]
        # tol: phase 2's B7 backward tolerance, 2% of the largest |dq|
        err, _, match = _compare(dq_f, dq_p, _rel_compare(dq_f, dq_p, 2e-2), 2e-2)
        grad_ok &= match
        print(f"entry point flash_attention flat [1,17776,3072] RoPE under grad: grad_fn "
              f"{type(o_f.grad_fn).__name__}, q.grad vs the plain B7 backward "
              f"max_abs_err={err:.3e} {'ok' if match else 'FAILED'}", flush=True)
    print(f"entry point flash_attention under grad: output tracked={tracked}; fused QK-LN "
          f"flat / bhsd raise={raised} {'ok' if grad_ok else 'FAILED'}", flush=True)
    ok &= grad_ok
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
    recompute); under "save_attn" each block runs twice but the joint
    attention's forward (B7 or B11) once, its outputs kept across the
    recompute; every backward runs once.
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
    a_mult = 1 if c.remat and c.remat_policy == "save_attn" else b_mult  # joint attention fwd
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
           "B7 fwd": flat * a_mult + spatial * g_mult, "B7 bwd": flat + spatial,
           "B8": stabs if temporal else 0, "B9": audio_ln + face_ln,
           "B10 fwd": 2 * hln * b_mult, "B10 bwd": 2 * hln,
           "B11": layout * a_mult, "B12+B13": layout, "B14": 0, "B2c": 0, "B2h": 0}
    return {k: v * micro_batches for k, v in per.items()}


def _train_batch(dit, b: int, gen, dev, vit_tokens: int = 577):
    """A batch with the keys of `TrainDriver.prepare_batch`'s on `dev`,
    drawn from `gen` with no VAE: noise as video latents, image (first
    frame) latents, text, the face inputs (`id_cond`, `id_vit_hidden`), 2
    audio tracks and the mute fixture, the identity matrix as the
    audio-face map, teacher routings from a left/right two-person mask and
    a dense face mask at latent resolution.  Where it differs from
    `prepare_batch`'s: the background latents are drawn (the driver's are
    zeros) and the noisy teacher is clean + 0.1 N(0, 1) clipped, without
    the 10% of entries replaced by uniforms."""
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


def _serving_model(args, steps: int):
    """The 5B DiT (42 layers, face + audio) and the VAE with bf16 weights
    drawn on the card from `--seed`, in a pipeline of `steps` denoise steps
    (DPM++, guidance 6, 49 x 480 x 720)."""
    import torch
    from bindyouravatar_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.models.vae import CausalVAE
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline

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
    return BindYourAvatarPipeline.create(dit, vae, PipelineConfig(num_inference_steps=steps))


def _serving_request(pipe, seed: int, rid: str, face: bool = True, **kw):
    """A request at the pipeline's geometry, its arrays drawn from `seed`."""
    import numpy as np
    from bindyouravatar_tpu_torch.serving import GenerationRequest

    c, a, lf, pc = pipe.dit.cfg, pipe.dit.audio_cfg, pipe.dit.lfe_cfg, pipe.cfg
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, fn=rng.normal: fn(size=shape).astype(np.float32)
    cond = dict(id_cond=f32(1, c.num_ids, lf.id_embed_dim),
                id_vit_hidden=f32(1, c.num_ids, lf.num_scales, 577, lf.vit_dim)) if face else {}
    n_af = pc.num_frames + a.window_size - a.window_stride
    return GenerationRequest(
        prompt_embeds=f32(1, c.max_text_seq_length, c.text_embed_dim),
        image=rng.uniform(-1, 1, (1, 1, 3, pc.height, pc.width)).astype(np.float32),
        audio_embeds=f32(1, 2, n_af, a.blocks, a.audio_dim), seed=seed, request_id=rid,
        **cond, **kw)


def _serving_want(dit, fwd_face: int, fwd_audio: int, preps: int) -> dict:
    """Each kernel's launches over `fwd_face` face + audio and `fwd_audio`
    audio-only CFG forwards (batch-2 CFG: one a step, whatever the batch)
    and `preps` once-per-clip conditioning preps.  A face + audio forward
    runs B1 42 (blocks) + 4 per face layer (STAB spatial), B2 1 and B4, B5
    4 per face layer, B3 42, B6 42 (audio norm_q) + 21 per face layer; an
    audio-only one B1 = B3 = B6 = 42; a prep one AudioProjModel B6."""
    c, a = dit.cfg, dit.audio_cfg
    n_ca, n_st = c.num_ca, dit.router_cfg.num_attention_layers
    face_b6 = 2 + 2 + 1 + 4 * n_st                 # perceiver, router norms, trunk, STABs
    return {"B1": c.num_layers * (fwd_face + fwd_audio) + n_ca * n_st * fwd_face,
            "B2": n_ca * fwd_face, "B3": a.num_layers * (fwd_face + fwd_audio),
            "B4": n_ca * n_st * fwd_face, "B5": n_ca * n_st * fwd_face, "B5'": 0,
            "B6": a.num_layers * (fwd_face + fwd_audio) + n_ca * face_b6 * fwd_face + preps,
            **{k: 0 for k in TRAIN_KERNELS + LAYOUT_KERNELS}}   # no backward


def _counts_ok(what: str, got: dict, want: dict) -> bool:
    ok = {k: got[k] for k in want} == want
    print(f"  {what} launches " + " ".join(f"{k}={got[k]} (want {want[k]})" for k in want
                                           if want[k] or got[k])
          + f" {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def _video_ok(what: str, video, shape) -> bool:
    import numpy as np

    ok = tuple(video.shape) == tuple(shape) and bool(np.isfinite(video).all())
    print(f"  {what}: video {tuple(video.shape)} finite={bool(np.isfinite(video).all())} "
          f"range=[{float(video.min()):.3f}, {float(video.max()):.3f}] "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


def serving_phase(args) -> bool:
    """Phase 4 on one fully conditioned DiT at the 5B geometry, each run's
    launch counts exact: `--requests` face + audio requests and 1
    audio-only request through the port's InferenceServer (whole decode);
    a request streamed in chunks of 4 latent frames against
    `decode(temporal_chunk=4)` of its latents, and the whole decode's and
    the chunked decode's seconds and peak; a forced-routing request against
    a direct `generate(routing_forcing=..., return_routing=True)` (bit for
    bit; the routing [steps, 21, 1, 17550, 2] bf16); one request through
    `serve_http` on 127.0.0.1; two co-batchable requests on a server with
    `batch_max=2`: one denoise, batch size 2."""
    import json as _json
    import tempfile
    import urllib.request

    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.serving import InferenceServer, serve_http

    dev = torch.device("cuda")
    pipe = _serving_model(args, args.steps)
    dit, pc = pipe.dit, pipe.cfg
    per = 2 if pc.cfg_microbatch else 1
    fwd = args.steps * per                          # CFG forwards per request
    shape = (1, pc.num_frames, 3, pc.height, pc.width)
    want = lambda face, audio, preps: _serving_want(dit, face * fwd, audio * fwd, preps)
    reqs = [_serving_request(pipe, args.seed + i, f"r{i} face+audio") for i in
            range(args.requests)]
    reqs.append(_serving_request(pipe, args.seed + args.requests, f"r{args.requests} audio-only",
                                 face=False))
    ok = True
    server = InferenceServer(pipe, dev)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        results = [f.result(timeout=1200) for f in [server.submit(r) for r in reqs]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"serving: {args.requests} face + audio and 1 audio-only requests x {args.steps} "
              f"steps, whole decode, in {wall:.2f} s wall, peak memory {peak:.2f} GiB", flush=True)
        for r in results:
            ok &= _video_ok(f"request {r.request_id} "
                            + " ".join(f"{k}={v:.3f}" for k, v in r.timings.items()), r.video, shape)
        ok &= _counts_ok("requests", counts, want(args.requests, 1, len(reqs)))

        # streaming: the latents of the request (decode=False), then the
        # same request streamed; the chunks against decode(temporal_chunk=4)
        chunks = []
        _reset_launches()
        lat = server.submit(_serving_request(pipe, args.seed + 20, "lat", decode=False)
                            ).result(timeout=1200).video
        streamed = server.submit(_serving_request(
            pipe, args.seed + 20, "stream", stream_chunk_frames=4,
            on_chunk=lambda start, arr: chunks.append((start, arr)))).result(timeout=1200)
        counts = _read_launches()
        lat_t = torch.from_numpy(lat).to(dev)
        decodes = {}
        with torch.inference_mode():
            for name, chunk in (("whole", None), ("chunk-4", 4)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out = pipe.vae.decode(lat_t, temporal_chunk=chunk).cpu().numpy()
                decodes[name] = (out, time.perf_counter() - t0,
                                 (torch.cuda.max_memory_allocated() - base) / 2**30)
        starts = [s for s, _ in chunks]
        want_starts = [0] + list(np.cumsum([c.shape[1] for _, c in chunks[:-1]]))
        joined = np.concatenate([c for _, c in chunks], axis=1)
        s_ok = (starts == want_starts and np.array_equal(joined, streamed.video)
                and np.array_equal(joined, decodes["chunk-4"][0]))
        ok &= s_ok and _video_ok("streamed request", streamed.video, shape)
        print(f"  streaming (4 latent frames a chunk): starts {starts}, chunks == result == "
              f"decode(temporal_chunk=4) of its latents bit for bit: {s_ok}; "
              + "; ".join(f"{k} decode {v[1]:.3f} s, peak {v[2]:.2f} GiB above weights and "
                          f"latents" for k, v in decodes.items()), flush=True)
        ok &= _counts_ok("latents + streamed", counts, want(2, 0, 2))
        del decodes, lat_t

        # forced routing: the server against a direct generate
        t = pipe.dit.cfg.video_seq_len
        rng = np.random.default_rng(args.seed + 30)
        force = np.zeros((1, t, dit.cfg.num_ids), np.float32)
        force[0, np.arange(t), rng.integers(0, dit.cfg.num_ids, t)] = 1.0
        freq = _serving_request(pipe, args.seed + 30, "forced", forced_routing=force)
        _reset_launches()
        forced = server.submit(freq).result(timeout=1200)
        g = lambda x: torch.from_numpy(x).to(dev)
        video, routing = pipe.generate(
            g(freq.prompt_embeds), torch.zeros_like(g(freq.prompt_embeds)), g(freq.image),
            torch.Generator(dev).manual_seed(freq.seed), return_routing=True,
            id_cond=g(freq.id_cond), id_vit_hidden=g(freq.id_vit_hidden),
            audio_embeds=g(freq.audio_embeds), routing_forcing=g(force))
        counts = _read_launches()
        same = np.array_equal(forced.video, video.cpu().numpy())
        r_shape = (args.steps, dit.cfg.num_ca, 1, t, dit.cfg.num_ids)
        r_ok = (tuple(routing.shape) == r_shape and routing.dtype == torch.bfloat16
                and bool(routing.isfinite().all()))
        ok &= same and r_ok and _video_ok("forced-routing request", forced.video, shape)
        print(f"  forced routing: server == direct generate(routing_forcing=...) bit for bit: "
              f"{same}; return_routing {tuple(routing.shape)} {routing.dtype} (want {r_shape} "
              f"bf16) {'ok' if r_ok else 'FAILED'}", flush=True)
        ok &= _counts_ok("forced (server + direct)", counts, want(2, 0, 2))
        del video, routing

        # HTTP: request r0's arrays as .npy paths; its clip again, bit for bit
        with tempfile.TemporaryDirectory(prefix="bya_http_") as tmp:
            spec = {"seed": reqs[0].seed, "request_id": "http", "output": f"{tmp}/out.npy"}
            for f in ("prompt_embeds", "image", "id_cond", "id_vit_hidden", "audio_embeds"):
                np.save(f"{tmp}/{f}.npy", getattr(reqs[0], f))
                spec[f] = f"{tmp}/{f}.npy"
            httpd = serve_http(server, host="127.0.0.1", port=0, block=False)
            try:
                port = httpd.server_address[1]
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                    health = _json.loads(r.read())
                _reset_launches()
                body = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                              data=_json.dumps(spec).encode(),
                                              headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(body, timeout=1200) as r:
                    reply = _json.loads(r.read())
                counts = _read_launches()
                video = np.load(reply["output"])
            finally:
                httpd.shutdown()
                httpd.server_close()
        single = reply["timings"]                  # a warm request alone
        h_ok = health["ok"] is True and np.array_equal(video, results[0].video)
        ok &= h_ok and _video_ok("HTTP request", video, shape)
        print(f"  serve_http on 127.0.0.1:{port}: healthz {health}, POST /generate -> "
              f"{reply['request_id']} timings {reply['timings']}; == request r0 bit for bit: "
              f"{np.array_equal(video, results[0].video)}", flush=True)
        ok &= _counts_ok("HTTP", counts, want(1, 0, 1))
    finally:
        server.close()

    # two co-batchable requests: one denoise at batch 2
    denoises = []
    real = pipe.denoise
    pipe.denoise = lambda *a, **kw: denoises.append(a[0].shape[0] // 2) or real(*a, **kw)
    server = InferenceServer(pipe, dev, batch_max=2, batch_wait_s=60.0)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        pair = [f.result(timeout=1200) for f in [
            server.submit(_serving_request(pipe, args.seed + 40 + i, f"pair{i}")) for i in (0, 1)]]
        torch.cuda.synchronize()
        counts = _read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        server.close()
        del pipe.denoise
    b_ok = denoises == [2] and all(r.timings["batch_size"] == 2.0 for r in pair)
    ok &= b_ok
    for r in pair:
        ok &= _video_ok(f"co-batched {r.request_id} "
                        + " ".join(f"{k}={v:.3f}" for k, v in r.timings.items()), r.video, shape)
    tp = pair[0].timings
    print(f"  co-batched pair: denoise calls at batch {denoises} (want [2]), batch_size 2: "
          f"{'ok' if b_ok else 'FAILED'}; a request {tp['compute_s'] / 2:.3f} s (denoise "
          f"{tp['denoise_s'] / 2:.3f} s) against {single['compute_s']:.3f} s ("
          f"{single['denoise_s']:.3f} s) alone (the HTTP request); peak {peak:.2f} GiB",
          flush=True)
    ok &= _counts_ok("co-batched pair", counts, want(1, 0, 1))
    print(f"serving phase {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def clip_phase(args, launches: dict) -> bool:
    """Phase 7: one face + audio request through the InferenceServer at
    `--clip-steps` denoise steps (50: a clip) on the 42-layer 5B model,
    weights and conditioning drawn on the card from `--seed`, whole decode;
    fills `launches` with the run's counts."""
    import gc

    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.serving import GenerationRequest, InferenceServer

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    pipe = _serving_model(args, args.clip_steps)
    c, a, lf, pc = pipe.dit.cfg, pipe.dit.audio_cfg, pipe.dit.lfe_cfg, pipe.cfg
    gen = torch.Generator(dev).manual_seed(args.seed + 100)
    draw = lambda *shape: torch.randn(shape, generator=gen, device=dev).cpu().numpy()
    req = GenerationRequest(
        prompt_embeds=draw(1, c.max_text_seq_length, c.text_embed_dim),
        negative_prompt_embeds=draw(1, c.max_text_seq_length, c.text_embed_dim),
        image=(torch.rand((1, 1, 3, pc.height, pc.width), generator=gen, device=dev) * 2 - 1
               ).cpu().numpy(),
        id_cond=draw(1, c.num_ids, lf.id_embed_dim),
        id_vit_hidden=draw(1, c.num_ids, lf.num_scales, 577, lf.vit_dim),
        audio_embeds=draw(1, 2, pc.num_frames + a.window_size - a.window_stride, a.blocks,
                          a.audio_dim),
        seed=args.seed + 100, request_id="clip")
    server = InferenceServer(pipe, dev)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        res = server.submit(req).result(timeout=3000)
        torch.cuda.synchronize()
        launches.update(_read_launches())
    finally:
        server.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = args.clip_steps
    ok = _video_ok("clip", res.video, (1, pc.num_frames, 3, pc.height, pc.width))
    ok &= _counts_ok("clip", launches, _serving_want(pipe.dit, steps, 0, 1))
    tm = res.timings
    print(f"clip (face + audio, {c.num_layers} layers, {steps} DPM++ steps, guidance "
          f"{pc.guidance_scale}, {pc.num_frames} x {pc.height} x {pc.width}, whole decode): "
          + " ".join(f"{k}={tm[k]:.3f}" for k in ("prep_s", "encode_s", "denoise_s", "decode_s",
                                                   "compute_s"))
          + f"; {tm['denoise_s'] / steps:.4f} s a denoise step; peak {peak:.2f} GiB; launches a "
          f"step " + " ".join(f"{k}={launches[k] / steps:g}" for k in ("B1", "B2", "B3", "B4",
                                                                       "B5", "B6"))
          + f" {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def _cli_inputs(tmp: str, seed: int) -> list:
    """Phase 7b's CLI arguments: two audio tracks at the 5B contract [53,
    12, 768] and the mute track as .pt, prompt embeddings as .npy, all
    written into `tmp` from `seed`."""
    import numpy as np
    import torch

    gen = torch.Generator().manual_seed(seed)
    paths = {}
    for name in ("a0", "a1", "mute"):
        paths[name] = f"{tmp}/{name}.pt"
        torch.save(torch.randn(53, 12, 768, generator=gen), paths[name])
    for name in ("pe", "ne"):
        paths[name] = f"{tmp}/{name}.npy"
        np.save(paths[name], torch.randn(1, 226, 4096, generator=gen).numpy())
    return ["--model_size", "5b", "--num_layers", "42", "--num_inference_steps", "2",
            "--audio_path", paths["a0"], paths["a1"], "--mute_audio_path", paths["mute"],
            "--prompt_embeds", paths["pe"], "--negative_prompt_embeds", paths["ne"],
            "--output_dir", f"{tmp}/out"]


def cli_phase(args, peaks: dict) -> bool:
    """Phase 7b: the CLI's `run` in this process at `--model_size 5b
    --num_layers 42 --num_inference_steps 2` with two audio tracks at the
    5B contract [53, 12, 768] and the mute track as .pt, and prompt
    embeddings as .npy; then `main`'s mp4 export of the clip, which must
    write the file or, without OpenCV, raise.  Its peak goes into
    `peaks["7b"]`."""
    import gc
    import importlib.util
    import tempfile
    import types

    import torch
    from bindyouravatar_tpu_torch import infer
    from bindyouravatar_tpu_torch.config import AudioConfig, DiTConfig, RouterConfig
    from bindyouravatar_tpu_torch.utils import media

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="bya_cli_") as tmp:
        argv = _cli_inputs(tmp, args.seed + 200) + ["--seed", str(args.seed)]
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        res = infer.run(infer.get_args(argv))
        torch.cuda.synchronize()
        wall, counts = time.perf_counter() - t0, _read_launches()
        peak = peaks["7b"] = torch.cuda.max_memory_allocated() / 2**30
        # main's export: the mp4, or an ImportError where OpenCV is missing
        mp4 = f"{tmp}/out/output.mp4"
        try:
            media.export_to_video(res.video[0], mp4)
            cv2_ok = os.path.getsize(mp4) > 0
            cv2_line = f"export_to_video wrote {os.path.getsize(mp4)} bytes"
        except ImportError as e:
            cv2_ok = importlib.util.find_spec("cv2") is None
            cv2_line = f"export_to_video raises {type(e).__name__} ({e})"
    meta_ok = res.meta["frames"] == 49 and res.meta["steps"] == 2
    ok = _video_ok("CLI run", res.video, (1, 49, 3, 480, 720)) and meta_ok and cv2_ok
    five_b = types.SimpleNamespace(cfg=DiTConfig(), audio_cfg=AudioConfig(),
                                   router_cfg=RouterConfig())
    ok &= _counts_ok("CLI (audio only: no --img_file_path)", counts,
                     _serving_want(five_b, 0, 2, 1))
    print(f"cli: python -m bindyouravatar_tpu_torch.infer {' '.join(argv[:6])} ... -> run() in "
          f"{wall:.1f} s (weights drawn in fp32 and cast to bf16 included), peak {peak:.2f} GiB, "
          f"meta {res.meta}; {cv2_line} {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def _face_checkpoints(tmp: str, seed: int) -> list:
    """The face stack's checkpoint flags, each naming a file in `tmp` that
    `torch.save` wrote from a port network drawn from `seed` (its
    `state_dict` has the reference checkpoint's names and layouts).  Drawn
    detection heads find no face or thousands, so RetinaFace's heads are
    set: a face at every stride-32 anchor and none at the others, its 5
    landmarks on the ArcFace template scaled to the anchor."""
    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.preprocess import arcface, bisenet, retinaface
    from bindyouravatar_tpu_torch.preprocess.face import ARCFACE_DST

    gen = torch.Generator().manual_seed(seed)
    flags = []
    for name, cls in (("arcface", arcface.IResNet100), ("retinaface", retinaface.RetinaFace),
                      ("bisenet", bisenet.BiSeNet)):
        net = arcface.build(cls, "cpu", gen)
        if name == "retinaface":
            lm = torch.from_numpy(np.tile(((ARCFACE_DST / 112.0 - 0.5) / 0.1).reshape(-1), 2))
            with torch.no_grad():
                for i in range(3):
                    for head in (net.ClassHead[i], net.BboxHead[i], net.LandmarkHead[i]):
                        head.conv1x1.weight.zero_()
                    net.ClassHead[i].conv1x1.bias.copy_(
                        torch.tensor([-4.0, 4.0] * 2 if i == 2 else [4.0, -4.0] * 2))
                    net.BboxHead[i].conv1x1.bias.zero_()
                    net.LandmarkHead[i].conv1x1.bias.copy_(lm)
        path = f"{tmp}/{name}.pth"
        torch.save(net.state_dict(), path)
        flags += [f"--{name}_checkpoint", path]
    return flags


def cli_face_phase(args, peaks: dict) -> bool:
    """Phase 7c: the CLI's `run` from two face images
    (`assets/faces/000_{0,1}.png`) through the three face checkpoint flags
    (`_face_checkpoints`) at `--model_size 5b --num_layers 42
    --num_inference_steps 2`, with phase 7b's audio and prompt files (T5
    from `--t5_dir` needs a tokenizer directory, which the card's machine
    does not have: phase 8 runs the T5 encoder itself).  The face stack
    (EVA-CLIP-L drawn from seed 0) runs and is freed before the DiT is
    built: `id_cond` [1, 2, 1280] and `id_vit_hidden` [1, 2, 5, 577, 1024]
    reach `generate` with the composite canvas (not the white frame), the
    clip has 2 face + audio forwards' launches, and the peak stays within
    1 GiB of phase 7b's."""
    import gc
    import tempfile
    import types

    import torch
    from bindyouravatar_tpu_torch import infer
    from bindyouravatar_tpu_torch.config import AudioConfig, DiTConfig, RouterConfig
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline

    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    faces = [os.path.join(here, "assets", "faces", f"000_{i}.png") for i in (0, 1)]
    seen = {}
    generate = BindYourAvatarPipeline.generate

    def recording(self, pe, ne, image, gen, **kw):
        seen.update(image=image, **{k: kw.get(k) for k in ("id_cond", "id_vit_hidden")})
        return generate(self, pe, ne, image, gen, **kw)

    with tempfile.TemporaryDirectory(prefix="bya_cli_face_") as tmp:
        argv = (_cli_inputs(tmp, args.seed + 200) + ["--seed", str(args.seed), "--img_file_path",
                                                     *faces] + _face_checkpoints(tmp, args.seed))
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        BindYourAvatarPipeline.generate = recording
        try:
            t0 = time.perf_counter()
            res = infer.run(infer.get_args(argv))
            torch.cuda.synchronize()
            wall, counts = time.perf_counter() - t0, _read_launches()
        finally:
            BindYourAvatarPipeline.generate = generate
        peak = peaks["7c"] = torch.cuda.max_memory_allocated() / 2**30
    shape = lambda t: None if t is None else list(t.shape)
    ok = _video_ok("CLI from images", res.video, (1, 49, 3, 480, 720))
    cond_ok = (shape(seen.get("id_cond")) == [1, 2, 1280]
               and shape(seen.get("id_vit_hidden")) == [1, 2, 5, 577, 1024]
               and bool(seen["id_cond"].isfinite().all())
               and bool(seen["id_vit_hidden"].isfinite().all()))
    white = float((seen["image"] == 1.0).float().mean())
    peak_ok = abs(peak - peaks["7b"]) <= 1.0
    five_b = types.SimpleNamespace(cfg=DiTConfig(), audio_cfg=AudioConfig(),
                                   router_cfg=RouterConfig())
    ok &= _counts_ok("CLI from images (face + audio)", counts, _serving_want(five_b, 2, 0, 1))
    ok &= cond_ok and white < 1.0 and peak_ok
    print(f"cli from images: --img_file_path assets/faces/000_0.png 000_1.png "
          f"--retinaface_checkpoint --bisenet_checkpoint --arcface_checkpoint (drawn nets, "
          f"reference names) -> id_cond {shape(seen.get('id_cond'))}, id_vit_hidden "
          f"{shape(seen.get('id_vit_hidden'))} {'ok' if cond_ok else 'FAILED'}; the canvas "
          f"{100 * white:.1f}% white pixels (not the white frame); run() in {wall:.1f} s, peak "
          f"{peak:.2f} GiB against phase 7b's {peaks['7b']:.2f} (within 1 GiB: {peak_ok}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


def cli_two_stage_phase(args, peaks: dict) -> bool:
    """Phase 7d: the CLI's `main` with `--two_stage_generate` from phase
    7c's inputs (two faces through the three face checkpoint flags, two
    audio tracks, prompt embeddings) at `--model_size 5b --num_layers 42
    --num_inference_steps 2`, 49 x 480 x 720.  SAM2 comes from a sam2.1-keyed
    checkpoint file of the `sam2.1_hiera_large` geometry drawn on the card
    (`$BYA_SAM2_CKPT`), the tool's frame-0 faces from 7c's RetinaFace file
    (`$BYA_RETINAFACE_CKPT`).  Both stages run on one pipeline: stage 1
    unforced, the mask tool over its mp4 (49 frames per identity), stage 2
    forced by a routing that is not all one value; launches are twice 7c's,
    exact; the mp4 exists and both clips are finite.  Prints `main`'s wall,
    the tool's seconds and the peak beside 7c's."""
    import contextlib
    import gc
    import io
    import tempfile
    import types

    import numpy as np
    import torch
    from bindyouravatar_tpu_torch import infer
    from bindyouravatar_tpu_torch.config import AudioConfig, DiTConfig, RouterConfig
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
    from bindyouravatar_tpu_torch.preprocess.sam2_video import build_sam2

    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    faces = [os.path.join(here, "assets", "faces", f"000_{i}.png") for i in (0, 1)]
    stages = []
    generate = BindYourAvatarPipeline.generate

    def recording(self, *a, **kw):
        out = generate(self, *a, **kw)
        f = kw.get("routing_forcing")
        stages.append({"forcing": None if f is None else f.float().cpu().numpy(),
                       "shape": list(out.shape), "finite": bool(out.float().isfinite().all())})
        return out

    env = {k: os.environ.get(k) for k in ("BYA_SAM2_CKPT", "BYA_RETINAFACE_CKPT")}
    with tempfile.TemporaryDirectory(prefix="bya_cli_2stage_") as tmp:
        sam = build_sam2(None, "cuda", torch.Generator("cuda").manual_seed(args.seed + 500))
        ckpt = f"{tmp}/sam2.1_hiera_large_drawn.pt"
        torch.save({"model": {k: v.cpu() for k, v in sam.state_dict().items()}}, ckpt)
        del sam
        gc.collect()
        torch.cuda.empty_cache()
        face_flags = _face_checkpoints(tmp, args.seed)
        argv = (_cli_inputs(tmp, args.seed + 200) + ["--seed", str(args.seed), "--img_file_path",
                                                     *faces, "--two_stage_generate"] + face_flags)
        os.environ["BYA_SAM2_CKPT"] = ckpt
        os.environ["BYA_RETINAFACE_CKPT"] = face_flags[face_flags.index(
            "--retinaface_checkpoint") + 1]
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        BindYourAvatarPipeline.generate = recording
        out = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                path = infer.main(argv)
            torch.cuda.synchronize()
            wall, counts = time.perf_counter() - t0, _read_launches()
        finally:
            BindYourAvatarPipeline.generate = generate
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        peak = torch.cuda.max_memory_allocated() / 2**30
        meta = json.loads(out.getvalue().strip().splitlines()[-1])
        per_id = [len(os.listdir(os.path.join(meta["mask_dir"], i))) for i in ("1", "2")]
        mp4 = os.path.getsize(path) if os.path.isfile(path) else 0
        ckpt_gb = os.path.getsize(ckpt) / 1e9
    forcing = stages[-1]["forcing"] if len(stages) == 2 else None
    values = np.unique(forcing) if forcing is not None else np.zeros(0)
    forced_ok = (len(stages) == 2 and stages[0]["forcing"] is None and forcing is not None
                 and len(values) > 1 and per_id == [49, 49])
    finite = all(st["finite"] for st in stages)
    video_ok = finite and all(st["shape"] == [1, 49, 3, 480, 720] for st in stages)
    five_b = types.SimpleNamespace(cfg=DiTConfig(), audio_cfg=AudioConfig(),
                                   router_cfg=RouterConfig())
    ok = _counts_ok("two-stage CLI (twice 7c's)", counts, _serving_want(five_b, 4, 0, 2))
    ok &= forced_ok and video_ok and mp4 > 0
    print(f"cli two-stage: --two_stage_generate (SAM2 sam2.1_hiera_large drawn, {ckpt_gb:.2f} GB "
          f"checkpoint; RetinaFace prompts) -> masks {per_id} frames per identity, stage 2 forcing "
          f"{list(forcing.shape) if forcing is not None else None} with {len(values)} values "
          f"{'ok' if forced_ok else 'FAILED'}; clips {[st['shape'] for st in stages]} finite="
          f"{finite}; mp4 {mp4} bytes; main() in {wall:.1f} s (stage 1 "
          f"{meta.get('stage1_seconds')} s, mask tool {meta.get('mask_tool_seconds')} s, stage 2 "
          f"{meta.get('stage2_seconds')} s), peak {peak:.2f} GiB against phase 7c's "
          f"{peaks.get('7c', float('nan')):.2f} {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def encoder_phase(args) -> bool:
    """Phase 8: each conditioning encoder at full size with bf16 weights
    drawn on the card from `--seed`: T5-XXL's encoder on 2 x 226 tokens (the
    prompt and the negative, the second padded after 100), EVA02-CLIP-L on
    [2, 3, 336, 336], IR-100 on [2, 3, 112, 112], RetinaFace-R50 on one
    480 x 720 image (padded to 480 x 736 as the detector pads it), BiSeNet
    on [2, 3, 512, 512]: shapes, finiteness, CUDA-event ms (median of 5)
    and peak memory.  Then on the card in bf16 against the same weights on
    the CPU in fp32: T5 and EVA-CLIP at 2 blocks of their full widths, the
    three networks whole (RetinaFace's raw loc / conf / landm heads)."""
    import gc

    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.config import EVACLIPConfig, T5Config
    from bindyouravatar_tpu_torch.models.eva_clip import EVAVisionTower
    from bindyouravatar_tpu_torch.models.t5 import T5Encoder
    from bindyouravatar_tpu_torch.preprocess import arcface, bisenet, retinaface

    dev, bf, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(dev).manual_seed(args.seed + 300)
    rng = np.random.default_rng(args.seed + 300)
    mask = np.ones((2, 226), bool)
    mask[1, 100:] = False
    text = (torch.from_numpy(rng.integers(0, 32128, (2, 226))), torch.from_numpy(mask))
    img = rng.integers(0, 256, (480, 720, 3), dtype=np.uint8)
    bgr = np.zeros((480, 736, 3), np.float32)
    bgr[:, :720] = img[..., ::-1] - np.asarray(retinaface.MEAN_BGR, np.float32)
    inputs = {
        "t5": text,
        "eva": (torch.from_numpy(rng.normal(size=(2, 3, 336, 336)).astype(np.float32)),),
        "arcface": (torch.from_numpy(rng.uniform(-1, 1, (2, 3, 112, 112)).astype(np.float32)),),
        "retinaface": (torch.from_numpy(bgr.transpose(2, 0, 1)[None].copy()),),
        "bisenet": (torch.from_numpy(rng.normal(size=(2, 3, 512, 512)).astype(np.float32)),),
    }
    cnn = {"arcface": arcface.IResNet100, "retinaface": retinaface.RetinaFace,
           "bisenet": bisenet.BiSeNet}

    def build(name, depth=None, device=dev, dtype=bf):
        """(the network, its reduced-depth twin or None) at `dtype`."""
        if name == "t5":
            kw = {} if depth is None else {"num_layers": depth}
            return T5Encoder.create(T5Config(dtype=dtype, param_dtype=dtype, **kw), device,
                                    gen if device == dev else None)
        if name == "eva":
            kw = {} if depth is None else {"depth": depth, "hidden_taps": (0, 1)}
            return EVAVisionTower.create(EVACLIPConfig(dtype=dtype, param_dtype=dtype, **kw),
                                         device, gen if device == dev else None)
        return arcface.build(cnn[name], device, gen if device == dev else None).to(dtype)

    # tol: relative L2 of the card's bf16 output against the CPU's fp32 on
    # the same (bf16-rounded) weights.  T5 and EVA-CLIP, 2 blocks: bf16
    # activations and products round to 2^-9 relative, fp32 sums; the CNNs
    # carry bf16 rounding through every conv and BN (IR-100: 100 convs)
    tol = {"t5": 2e-2, "eva": 2e-2, "arcface": 5e-2, "retinaface": 5e-2, "bisenet": 5e-2}
    desc = {"t5": "T5-XXL encoder 24 x 4096, 64 heads, d_ff 10240, [2, 226] tokens",
            "eva": "EVA02-CLIP-L-336 24 x 1024, 16 heads, [2, 3, 336, 336]",
            "arcface": "IR-100 [2, 3, 112, 112]", "retinaface": "RetinaFace-R50 [1, 3, 480, 736]",
            "bisenet": "BiSeNet [2, 3, 512, 512]"}
    ok = True
    for name, x in inputs.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            net = build(name)
            n_params = sum(p.numel() for p in net.parameters())
            weights = torch.cuda.memory_allocated() / 2**30
            xd = tuple(t.to(dev) for t in x)
            outs = net(*xd)
            outs = outs if isinstance(outs, tuple) else (outs,)
            torch.cuda.synchronize()
            ms = _time_ms(lambda: net(*xd), runs=5)
            peak = torch.cuda.max_memory_allocated() / 2**30
            shapes = [list(o.shape) for o in outs]
            finite = all(bool(o.float().isfinite().all()) for o in outs)
            del net, outs
            reduced = 2 if name in ("t5", "eva") else None
            gpu = build(name, reduced) if reduced else build(name)
            cpu = build(name, reduced, "cpu", f32) if reduced else build(name, None, "cpu", f32)
            cpu.load_state_dict({k: v.float().cpu() for k, v in gpu.state_dict().items()})
            got, want = gpu(*xd), cpu(*x)
            got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
            rels = [float((g.float().cpu() - w).norm() / w.norm()) for g, w in zip(got, want)]
            del gpu, cpu, got, want
        agree = max(rels) <= tol[name]
        ok &= finite and agree
        what = f"{reduced} blocks, widths full" if reduced else "whole"
        print(f"encoder {desc[name]}: {n_params / 1e6:.1f}M params bf16 ({weights:.2f} GiB), "
              f"outputs {shapes} finite={finite}; {ms:.3f} ms (CUDA events), peak {peak:.2f} "
              f"GiB; {what}: cuda-bf16 vs cpu-fp32 relative L2 "
              f"{' / '.join(f'{r:.2e}' for r in rels)} (tol {tol[name]:g}) "
              f"{'ok' if finite and agree else 'FAILED'}", flush=True)
    print(f"encoder phase {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def _sam2_frames(t: int, h: int, w: int, seed: int):
    """A synthetic clip [t, h, w, 3] uint8: two bright discs drifting over a
    noisy background."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = rng.integers(0, 60, (t, h, w, 3)).astype(np.uint8)
    for i in range(t):
        for cx, col in ((0.3 * w + 2 * i, (220, 180, 160)), (0.7 * w - 2 * i, (160, 200, 230))):
            out[i][(xx - cx) ** 2 + (yy - 0.45 * h) ** 2 < (0.15 * h) ** 2] = col
    return out


def _sam2_track(predictor, frames):
    """Two objects prompted on frame 0 at the mask tool's default points,
    then propagated: ([T, 2, h4, w4] mask logits (numpy), the state,
    `init_state`'s seconds, `propagate_in_video`'s seconds)."""
    import numpy as np
    import torch

    h, w = frames.shape[1:3]
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    state = predictor.init_state(frames)
    sync()
    init_s = time.perf_counter() - t0
    for oid, pt in ((1, (0.3 * w, 0.4 * h)), (2, (0.7 * w, 0.4 * h))):
        predictor.add_new_points(state, 0, oid, np.array([pt], np.float32), np.array([1]))
    t0 = time.perf_counter()
    masks = np.stack([m for _, _, m in predictor.propagate_in_video(state)])
    sync()
    return masks, state, init_s, time.perf_counter() - t0


def sam2_upscaler_phase(args) -> bool:
    """Phase 9: SAM2 and the upscaler at their published sizes, weights
    drawn on the card from `--seed`, fp32 weights and activations as JAX's
    (matrix products in fp32; cuDNN's convolutions may take TF32, PyTorch's
    default).  SAM2 at `sam2.1_hiera_large` (`SAM2Config()`, image 1024):
    the image encoder's ms a frame (CUDA events, median of 5); then the
    video predictor over a 49 x 480 x 720 clip with 2 objects:
    `init_state`'s and `propagate_in_video`'s seconds, the bank full at 7
    memories + 16 pointers, the peak.  RRDBNet at `RealESRGAN_x4plus` (23
    RRDBs, 64 features, grow 32, x4) through `tiled_scale` (512 tiles,
    overlap 32) on one 480 x 720 frame: ms (median of 3) and peak.  Each
    against the CPU in fp32 on the same weights at reduced depth: SAM2 with
    one block a stage and one memory-attention layer, at image 1024, 3
    frames; RRDBNet with 2 RRDBs on a 120 x 180 frame in 64 tiles, overlap
    8; relative L2 of every mask logit / of the output within the stated
    bound."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.models.rrdbnet import build_rrdbnet
    from bindyouravatar_tpu_torch.models.sam2 import HieraConfig, SAM2Config
    from bindyouravatar_tpu_torch.preprocess.sam2_video import SAM2VideoPredictor, build_sam2
    from bindyouravatar_tpu_torch.utils.upscale import tiled_scale

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed + 600)
    rel = lambda g, w: float(np.linalg.norm(np.asarray(g, np.float64) - w)
                             / np.linalg.norm(np.asarray(w, np.float64)))
    # tol: relative L2 against the CPU's fp32 on the same weights.  TF32
    # convolutions round their inputs to 10 mantissa bits (~5e-4 relative
    # a product); the bound leaves that a factor 10
    tol = {"sam2": 5e-3, "rrdbnet": 5e-3}
    ok = True

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = SAM2Config()
    with torch.no_grad():
        model = build_sam2(cfg, dev, gen)
        n_params = sum(p.numel() for p in model.parameters())
        x = torch.randn(1, 3, cfg.image_size, cfg.image_size, generator=gen, device=dev)
        enc_ms = _time_ms(lambda: model.encode_image(x), runs=5)
    frames = _sam2_frames(49, 480, 720, args.seed)
    pred = SAM2VideoPredictor(model)
    masks, state, init_s, prop_s = _sam2_track(pred, frames)
    obj = state["objs"][1]
    bank = pred._memory_bank(obj)[0].shape[1]
    full = len(obj.memories) == cfg.num_maskmem - 1 and len(obj.obj_ptrs) == cfg.max_obj_ptrs
    sam_peak = torch.cuda.max_memory_allocated() / 2**30
    sam_ok = masks.shape == (49, 2, 256, 256) and bool(np.isfinite(masks).all()) and full
    fg = float((masks > 0).mean())
    del model, pred, state, x
    gc.collect()
    torch.cuda.empty_cache()

    red = dataclasses.replace(cfg, hiera=dataclasses.replace(
        HieraConfig.large(), stages=(1, 1, 1, 1), global_att_blocks=(2,)), memory_attn_layers=1)
    gpu = build_sam2(red, dev, gen)
    cpu = build_sam2(red, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    got = _sam2_track(SAM2VideoPredictor(gpu), frames[:3])[0]
    want = _sam2_track(SAM2VideoPredictor(cpu), frames[:3])[0]
    sam_rel = max(rel(got[t, o], want[t, o]) for t in range(3) for o in range(2))
    sam_ok &= sam_rel <= tol["sam2"]
    del gpu, cpu
    ok &= sam_ok
    print(f"sam2 sam2.1_hiera_large fp32 ({n_params / 1e6:.1f}M params, image "
          f"{cfg.image_size}): image encoder {enc_ms:.3f} ms a frame (CUDA events); 49 x 480 x "
          f"720 x 2 objects: init_state {init_s:.2f} s, propagate_in_video {prop_s:.2f} s "
          f"({1e3 * prop_s / 49:.1f} ms a frame), bank {len(obj.memories) + 1} memories + "
          f"{len(obj.obj_ptrs)} pointers = {bank} rows (full: {full}), foreground "
          f"{100 * fg:.1f}%, peak {sam_peak:.2f} GiB; 1 block a stage, 1 memory layer, 3 frames: "
          f"cuda vs cpu-fp32 relative L2 {sam_rel:.2e} (tol {tol['sam2']:g}) "
          f"{'ok' if sam_ok else 'FAILED'}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        net = build_rrdbnet(23, dev, gen)
        n_params = sum(p.numel() for p in net.parameters())
        frame = torch.rand(1, 3, 480, 720, generator=gen, device=dev)
        run = lambda: tiled_scale(frame, net, tile_x=512, tile_y=512, overlap=32,
                                  upscale_amount=4)
        up = run()
        torch.cuda.synchronize()
        rr_ms = _time_ms(run, runs=3)
        rr_peak = torch.cuda.max_memory_allocated() / 2**30
        rr_shape, rr_finite = list(up.shape), bool(up.isfinite().all())
        del net, up
        small = torch.rand(1, 3, 120, 180, generator=gen, device=dev)
        gnet = build_rrdbnet(2, dev, gen)
        cnet = build_rrdbnet(2, "cpu")
        cnet.load_state_dict({k: v.cpu() for k, v in gnet.state_dict().items()})
        tile = dict(tile_x=64, tile_y=64, overlap=8, upscale_amount=4)
        rr_rel = rel(tiled_scale(small, gnet, **tile).cpu().numpy(),
                     tiled_scale(small.cpu(), cnet, **tile).numpy())
    rr_ok = rr_shape == [1, 3, 1920, 2880] and rr_finite and rr_rel <= tol["rrdbnet"]
    ok &= rr_ok
    print(f"rrdbnet RealESRGAN_x4plus fp32 ({n_params / 1e6:.2f}M params, 23 RRDBs) through "
          f"tiled_scale (512 tiles, overlap 32, 2 tiles) on [1, 3, 480, 720] -> {rr_shape} "
          f"finite={rr_finite}: {rr_ms:.1f} ms (CUDA events), peak {rr_peak:.2f} GiB; 2 RRDBs on "
          f"[1, 3, 120, 180] in 64 tiles: cuda vs cpu-fp32 relative L2 {rr_rel:.2e} (tol "
          f"{tol['rrdbnet']:g}) {'ok' if rr_ok else 'FAILED'}", flush=True)
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
    return ok & save_attn_phase(args, tr, batch)


def save_attn_phase(args, tr, batch) -> bool:
    """Phase 5b: one optimizer step's micro-batches (`grads_and_metrics`,
    forward + backward, no update) of the phase-5 model, weights and batch
    under `remat_policy="save_attn"`, against the same under "nested" with
    the same draws: the loss within 1e-3 relative, each trainable gradient
    within 10% relative L2 (dq's sums run in no fixed order, so the two
    are not bitwise equal; an attention key bias's true gradient is 0,
    softmax being invariant to it, so its rounding noise is held to 10% of
    its query bias's gradient instead); the launches of both runs (the
    joint attention's forward once per block under "save_attn"), their
    peak memory and walls."""
    import dataclasses

    import torch

    dit = tr.dit
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed + 300)
    accum = tr.cfg.grad_accum_steps
    draws = [tr.draw({"video_latents": batch["video_latents"][j:j + 1]}, gen)
             for j in range(accum)]
    runs = {}
    for policy in ("nested", "save_attn"):
        dit.cfg = dataclasses.replace(dit.cfg, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        grads, metrics = tr.grads_and_metrics(batch, draws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the reference's gradients wait on the host, so the device holds one set
        runs[policy] = (wall, peak, counts, train_launches(dit, accum), float(metrics["loss"]),
                        {k: g.detach().float().cpu() for k, g in grads.items()})
        del grads
    dit.cfg = dataclasses.replace(dit.cfg, remat_policy="nested")
    (w_n, p_n, counts_n, want_n, loss_n, g_n) = runs["nested"]
    (w_s, p_s, counts, want, loss_s, g_s) = runs["save_attn"]
    loss_ok = abs(loss_s - loss_n) <= 1e-3 * abs(loss_n)
    def rel_l2(k):
        ref = g_n[k[:-len("to_k.bias")] + "to_q.bias"] if k.endswith("to_k.bias") else g_n[k]
        d = float((g_s[k] - g_n[k]).norm())
        return d / float(ref.norm()) if float(ref.norm()) > 0 else d

    rel = {k: rel_l2(k) for k in g_n}
    worst = sorted(rel, key=rel.get)[-3:][::-1]
    grads_ok = rel[worst[0]] <= 0.1
    counts_ok = (all(counts[k] == want[k] for k in want)
                 and all(counts_n[k] == want_n[k] for k in want_n))
    ok = loss_ok and grads_ok and counts_ok
    print(f"train save_attn ({dit.cfg.num_layers} layers, {accum} micro-batches, the phase-5 "
          f"weights and batch): loss {loss_s:.6g} vs nested {loss_n:.6g} (tol 1e-3 rel) "
          f"{'ok' if loss_ok else 'FAILED'}; {len(rel)} trainable gradients, worst relative L2 "
          + " ".join(f"{k}={rel[k]:.3e}" for k in worst)
          + f" tol=0.1 {'ok' if grads_ok else 'FAILED'}; wall "
          f"{w_s:.2f} s vs nested {w_n:.2f} s; peak memory {p_s:.2f} GiB vs nested "
          f"{p_n:.2f} GiB; launches "
          + " ".join(f"{k}={counts[k]} (want {want[k]}; nested {counts_n[k]})" for k in want)
          + f" {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def driver_phase(args) -> bool:
    """Phase 6: `training.sft.main` at `--model_size 5b` (`--driver-layers`
    deep, widths full), 2 steps and a checkpoint, then a resumed run to
    step 3; checks the restore, the rows of `metrics.jsonl`, the frozen
    tensors and each run's launch counts against `train_launches`."""
    import gc
    import shutil
    import tempfile
    import traceback

    import torch
    from bindyouravatar_tpu_torch.training import sft

    gc.collect()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="bya_sft_")
    argv = ["--model_size", "5b", "--output_dir", out, "--checkpointing_steps", "2",
            "--checkpoints_total_limit", "1", "--remat_policy", "nested",
            "--seed", str(args.seed), "--num_layers", str(args.driver_layers)]

    def digest(driver, state):
        tr = driver.trainer
        host = driver.host_state()
        return dict(params={k: _fingerprint(p) for k, p in tr.trainable.items()},
                    mu={k: _fingerprint(t) for k, t in state.mu.items()},
                    nu={k: _fingerprint(t) for k, t in state.nu.items()},
                    frozen={k: _fingerprint(p) for k, p in tr.frozen.items()},
                    sampler=host["sampler"], np_rng=host["np_rng"],
                    torch_rng=host["torch_rng"].tolist(), step=state.step)

    try:
        _reset_launches()
        t0 = time.perf_counter()
        first = sft.main(argv + ["--max_train_steps", "2", "--resume", "none"])
        torch.cuda.synchronize()
        wall1, counts1 = time.perf_counter() - t0, _read_launches()
        dit, accum = first.driver.trainer.dit, first.driver.cfg.grad_accum_steps
        want1, want2 = train_launches(dit, 2 * accum), train_launches(dit, accum)
        n_layers = dit.cfg.num_layers
        saved, log = digest(first.driver, first.state), list(first.driver.checkpoint_log)
        del first, dit
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30

        restored = {}
        _reset_launches()
        t0 = time.perf_counter()
        second = sft.main(argv + ["--max_train_steps", "3", "--resume", "latest"],
                          resume_fn=lambda d, s: restored.update(digest(d, s)))
        torch.cuda.synchronize()
        wall2, counts2 = time.perf_counter() - t0, _read_launches()
        final = digest(second.driver, second.state)
        log += second.driver.checkpoint_log
        del second
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        free = shutil.disk_usage(out).free
    except Exception as e:
        traceback.print_exc()
        print(f"driver (sft 5b): FAILED with {type(e).__name__}: {e}", flush=True)
        return False
    finally:
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    same = {k: restored.get(k) == saved[k]
            for k in ("params", "mu", "nu", "sampler", "np_rng", "torch_rng", "step")}
    rows_ok = ([r["step"] for r in rows] == [1, 2, 3]
               and all(math.isfinite(v) for r in rows for v in r.values()))
    frozen_ok = final["frozen"] == saved["frozen"]
    counts_ok = ({k: counts1[k] for k in want1} == want1
                 and {k: counts2[k] for k in want2} == want2)
    ok = all(same.values()) and final["step"] == 3 and rows_ok and frozen_ok and counts_ok
    for r in rows:
        print(f"driver step {r['step']}: prepare_batch {r['prepare_batch_s']:.2f} s (peak "
              f"{r['prepare_batch_peak_gib']:.2f} GiB), step {r['step_time_s']:.2f} s (peak "
              f"{r['step_peak_gib']:.2f} GiB); loss {r['loss']:.5g} grad_norm "
              f"{r['grad_norm']:.5g}", flush=True)
    for e in log:
        extra = (f" (+ sub-modules {e['modules_bytes'] / 1e9:.3f} GB in "
                 f"{e['modules_seconds']:.2f} s)" if e["event"] == "save" else "")
        print(f"driver checkpoint {e['event']} step {e['step']}: {e['bytes'] / 1e9:.3f} GB"
              f"{extra} in {e['seconds']:.2f} s", flush=True)
    print(f"driver (sft 5b, {n_layers} layers{'' if n_layers == 42 else ', depth cut from 42'}, "
          f"{accum} micro-batches a step): run 1 (2 steps) {wall1:.1f} s, run 2 (restore + "
          f"step 3) {wall2:.1f} s; {left:.2f} GiB left between runs; restored == saved "
          + " ".join(f"{k}={v}" for k, v in same.items())
          + f"; final step {final['step']}; metrics rows {len(rows)} finite={rows_ok}; frozen "
          f"{len(saved['frozen'])} tensors bit-identical={frozen_ok}; free disk "
          f"{free / 1e9:.1f} GB; launches run 1 "
          + " ".join(f"{k}={counts1[k]} (want {want1[k]})" for k in want1)
          + "; run 2 " + " ".join(f"{k}={counts2[k]} (want {want2[k]})" for k in want2)
          + f" {'ok' if ok else 'FAILED'}", flush=True)
    return ok


# Every kernel of the port: (route, source, the TPU kernel it replaces);
# the kernels line lists them in this order
KERNELS = {
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
    "B6": ("cuda", "bindyouravatar_tpu_torch/csrc/layernorm.cu",
           "bindyouravatar_tpu/ops/layernorm.py:26"),
    "B7 fwd": ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
               "bindyouravatar_tpu/ops/flash_attention.py:352"),
    "B7 bwd": ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention_bwd.cu",
               "bindyouravatar_tpu/ops/flash_attention.py:1050"),
    "B8": ("cuda", "bindyouravatar_tpu_torch/csrc/packed_attention.cu",
           "bindyouravatar_tpu/ops/packed_attention.py:351"),
    "B9": ("cuda", "bindyouravatar_tpu_torch/csrc/layernorm.cu",
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2, help="denoise steps per request")
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-steps", type=int, default=2, help="optimizer steps of phase 5")
    p.add_argument("--train-layers", type=int, default=42,
                   help="depth of the phase-5 DiT (widths stay full)")
    p.add_argument("--clip-steps", type=int, default=50,
                   help="denoise steps of phase 7's clip (0 skips phases 7 to 7d)")
    p.add_argument("--driver-layers", type=int, default=16,
                   help="depth of the phase-6 DiT (widths stay full; cut from 42: a save at 42 "
                        "layers writes 32.4 GB, and the phase saves twice)")
    p.add_argument("--only-kernels", metavar="NAMES",
                   help="run phase 2 for these kernels only (comma-separated names of the "
                        "kernels line, or their first word: 'B2,B3,B7'), then stop; fails on "
                        "purpose (no launch counts).  Run in two unpacked trees, it times two "
                        "versions of the kernels in one call")
    args = p.parse_args(argv)
    only = None
    if args.only_kernels:
        only = {n.strip() for n in args.only_kernels.split(",") if n.strip()}
        known = {n.split()[0] for n in KERNELS}
        if not only or not {n.split()[0] for n in only} <= known:
            p.error(f"--only-kernels: names among {sorted(known)}")

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
    print(f"build: {lib.name} (nvcc sm_90a: the flash forward of B1, B7 and B11, the fused "
          f"flash backward of B7 and B12 + B13, B2 + B3 + B14 + B2c + B2h, B5 + B8, B6 + B9) and "
          f"triton import in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = [ln for ln in (lib.parent / "nvcc.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    for line in ptxas:
        print(f"  ptxas: {line.strip()}", flush=True)

    results, launches, reduced_launches, train_launches_ = {}, {}, {}, {}
    unpaired_launches, entry_launches = {}, {}
    ok = kernel_phase(results, only)
    if only is not None:
        return _fail(f"--only-kernels: phase 2 of {sorted(only)} {'passed' if ok else 'FAILED'}, "
                     f"no other phase run")
    ok &= reduced_step_phase(reduced_launches)
    ok &= reduced_train_phase({})
    ok &= reduced_train_phase(unpaired_launches, unpaired=True)
    ok &= entry_point_phase(entry_launches)
    if args.requests > 0:
        ok &= serving_phase(args)
    else:
        ok = False
        print("serving phase skipped (--requests 0): no launch counts", flush=True)
    if args.train_steps > 0:
        ok &= train_phase(args, train_launches_)
    else:
        ok = False
        print("train phase skipped (--train-steps 0): no launch counts", flush=True)
    ok &= driver_phase(args)
    if args.clip_steps > 0:
        peaks = {}
        ok &= clip_phase(args, launches)
        ok &= cli_phase(args, peaks)
        ok &= cli_face_phase(args, peaks)
        ok &= cli_two_stage_phase(args, peaks)
    else:
        ok = False
        print("clip phases skipped (--clip-steps 0): no launch counts", flush=True)
    ok &= encoder_phase(args)
    ok &= sam2_upscaler_phase(args)
    if not ok:
        return _fail("a phase failed")

    # B1-B6: the launches of the clip (phase 7); B5' runs only below 8
    # latent frames: its launches are those of the reduced fully
    # conditioned step (3 frames)
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
    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], **results[name]}
               for name, (route, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
