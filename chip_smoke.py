#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # 42 layers, 2 requests x 2 denoise steps

Phases (one line each; any failure exits non-zero and prints no result):
  1. the card's `nvidia-smi` name and power limit; build every kernel.
  2. each kernel (B1 flash attention, B3 short-KV attention, B6 LayerNorm)
     against its plain PyTorch version on the card, at the serving path's
     shapes and at a ragged shape, with the stated tolerance, and both timed.
  3. a reduced audio-only DiT step on the card (kernels) against the same
     weights on the CPU (plain versions, fp32).
  4. the port's `InferenceServer` answers 2 requests through
     `pipeline.generate` at the 5B audio-only geometry (dim 3072, 48 x 64
     heads, 226 + 17,550 tokens, 49 x 480 x 720 video) with random weights
     drawn on the card from a seed; output shape, finiteness and each
     kernel's launch count are checked.
Then a JSON line with the kernels, and as the last line the device JSON.
There is no CPU fallback: without a CUDA device it fails at once.
"""

from __future__ import annotations

import argparse
import json
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
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import layernorm as ln
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv
    from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1234)
    rnd = lambda *shape, std=1.0, mean=0.0: (
        torch.randn(shape, generator=gen, device=dev) * std + mean)
    bf = torch.bfloat16
    ok_all = True

    def report(name, tag, got, want, atol, rtol, kern, plain, runs):
        nonlocal ok_all
        err, rel, ok = _compare(got, want, atol, rtol)
        ms, plain_ms = _time_ms(kern, runs), _time_ms(plain, max(1, runs // 2))
        ok_all &= ok
        print(f"kernel {name} {tag}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"tol=|d|<={atol}+{rtol}*|ref| {'ok' if ok else 'FAILED'} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        return err, ms, plain_ms

    # --- B1: joint self-attention, q/k/v [2, 17776, 48*64]; ragged S=1000 with
    # a masked kv tail; the bare path (no LN, no RoPE) at S=777
    # tol: both sides round LN/RoPE outputs and p to bf16; the kernel also
    # rounds the scaled q (one more bf16 ulp, ~0.4% of a logit)
    for tag, b, s, h, text_len, grid, kv_len in (
            ("slice[2,17776,3072]", 2, 17776, 48, 226, (13, 30, 45), None),
            ("ragged[1,1000,512] kv_len=937", 1, 1000, 8, 10, (3, 18, 18), 937),
            ("ragged[2,777,256] no LN/RoPE", 2, 777, 4, 0, None, None)):
        q, k, v = (rnd(b, s, h * 64).to(bf) for _ in range(3))
        kw = dict(kv_len=kv_len)
        if grid is not None:
            rope = get_3d_rotary_pos_embed(64, ((0, 0), grid[1:]), grid[1:], grid[0], device=dev)
            norm = (rnd(64, std=0.1, mean=1.0), rnd(64, std=0.1),
                    rnd(64, std=0.1, mean=1.0), rnd(64, std=0.1))
            kw.update(rope=rope, rope_start=text_len, qk_norm=norm)
        kern = lambda: fa.flash_attention(q, k, v, h, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, h, block_q=512, **kw)
        r = report("B1", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 5)
        if "slice" in tag:
            results["B1"] = r

    # --- B3: audio cross-attention, q [26, 1350, 3072], k/v [26, 2, 48, 32, 64]
    # tol: the plain version rounds each identity's output and the combine
    # to bf16, the kernel sums in fp32 and rounds once
    for tag, g, sq, w_uniform in (("slice[26,1350,3072] w=0.5", 26, 1350, True),
                                  ("slice[26,1350,3072] w~U(0,1)", 26, 1350, False),
                                  ("ragged[3,1000,3072]", 3, 1000, False)):
        q = rnd(g, sq, 48 * 64).to(bf)
        k, v = (rnd(g, 2, 48, 32, 64).to(bf) for _ in range(2))
        w = (torch.full((g, sq, 2), 0.5, device=dev) if w_uniform
             else torch.rand((g, sq, 2), generator=gen, device=dev)).to(bf)
        kern = lambda: skv.short_kv_attention_combined_flat(q, k, v, w, 0.125)
        plain = lambda: skv.short_kv_attention_combined_flat_plain(q, k, v, w, 0.125)
        r = report("B3", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 20)
        if tag.startswith("slice") and w_uniform:
            results["B3"] = r

    # --- B6: audio norm_q rows [2*17550, 3072], AudioProjModel [2*2*13*32, 768]
    # tol: one bf16 rounding of the same fp32 value, summed in another order
    for tag, rows, d in (("slice[35100,3072]", 35100, 3072), ("slice[1664,768]", 1664, 768),
                         ("ragged[1001,768]", 1001, 768)):
        x = rnd(rows, d, std=2.3, mean=0.7).to(bf)
        sc, bi = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1)
        kern = lambda: ln.fused_layernorm(x, sc, bi)
        plain = lambda: ln.layernorm_plain(x, sc, bi)
        r = report("B6", tag, kern(), plain(), 1e-2, 1e-2, kern, plain, 20)
        if tag == "slice[35100,3072]":
            results["B6"] = r
    return ok_all


def reduced_step_phase() -> bool:
    """A 2-layer audio-only DiT step at reduced widths on the card (kernels,
    bf16) against the same weights on the CPU (plain versions, fp32)."""
    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.config import AudioConfig, DiTConfig
    from bindyouravatar_tpu_torch.models.dit import DiT

    base = dict(num_attention_heads=4, attention_head_dim=64, in_channels=48,
                out_channels=16, time_embed_dim=64, text_embed_dim=128, num_layers=2,
                sample_width=24, sample_height=16, sample_frames=9, max_text_seq_length=16,
                is_train_face=False)
    acfg = AudioConfig(dim=256, audio_dim=128, num_attention_heads=4, attention_head_dim=64,
                       num_layers=2, blocks=2, intermediate_dim=64, context_tokens=32)
    ref = DiT.create(DiTConfig(dtype=torch.float32, param_dtype=torch.float32, **base), acfg,
                     generator=torch.Generator().manual_seed(7))
    gpu = DiT.create(DiTConfig(dtype=torch.bfloat16, param_dtype=torch.bfloat16, **base), acfg,
                     device="cuda")
    gpu.load_state_dict(ref.state_dict())
    c = ref.cfg
    rng = np.random.default_rng(7)
    n_af = c.sample_frames + acfg.window_size - acfg.window_stride
    inputs = dict(
        latents=rng.normal(size=(2, c.latent_frames, 48, 16, 24)),
        text_embeds=rng.normal(size=(2, 16, 128)),
        timesteps=np.array([999.0, 499.0]),
        audio_embeds=rng.normal(size=(2, 2, n_af, 2, 128)))
    outs = []
    with torch.inference_mode():
        for model, dev in ((ref, "cpu"), (gpu, "cuda")):
            t = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in inputs.items()}
            rope = model.rope(16 * 8, 24 * 8, c.latent_frames, device=dev)
            out, _ = model.apply(t["latents"], t["text_embeds"], t["timesteps"], rope,
                                 audio_embeds=t["audio_embeds"])
            outs.append(out.float().cpu())
    # tol: bf16 activations and weights through 2 blocks against fp32
    scale = float(outs[0].abs().max())
    err, rel, ok = _compare(outs[1], outs[0], 0.05 * scale, 0.05)
    print(f"reduced step (2 layers, dim 256, 16 + 288 tokens): cuda-bf16 vs cpu-fp32 "
          f"max_abs_err={err:.3e} (ref max {scale:.3e}) tol=|d|<={0.05 * scale:.3e}"
          f"+0.05*|ref| {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def serving_phase(args, launches: dict) -> bool:
    """Two requests through the port's InferenceServer at the 5B audio-only
    geometry; fills `launches` with each kernel's count over the run."""
    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.models.vae import CausalVAE
    from bindyouravatar_tpu_torch.ops.flash_attention import flash_attention
    from bindyouravatar_tpu_torch.ops.layernorm import fused_layernorm
    from bindyouravatar_tpu_torch.ops.short_kv_attention import short_kv_attention_combined_flat
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
    from bindyouravatar_tpu_torch.serving import GenerationRequest, InferenceServer

    dev = torch.device("cuda")
    bf = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(args.seed)
    dit = DiT.create(DiTConfig(is_train_face=False, is_train_audio=True, dtype=bf,
                               param_dtype=bf), device=dev, generator=gen)
    vae = CausalVAE.create(VAEConfig(param_dtype=bf), device=dev, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    print(f"model: DiT {n_params / 1e9:.3f}B params ({dit.cfg.num_layers} layers), VAE "
          f"{sum(p.numel() for p in vae.parameters()) / 1e6:.1f}M, bf16, drawn on the card "
          f"in {time.perf_counter() - t0:.1f} s; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    pcfg = PipelineConfig(num_inference_steps=args.steps, decode_temporal_chunk=4)
    pipe = BindYourAvatarPipeline.create(dit, vae, pcfg)
    c, a = dit.cfg, dit.audio_cfg
    n_af = pcfg.num_frames + a.window_size - a.window_stride
    reqs = []
    for i in range(args.requests):
        rng = np.random.default_rng(args.seed + 1 + i)
        reqs.append(GenerationRequest(
            prompt_embeds=rng.normal(size=(1, c.max_text_seq_length, c.text_embed_dim)).astype(np.float32),
            image=rng.uniform(-1, 1, (1, 1, 3, pcfg.height, pcfg.width)).astype(np.float32),
            audio_embeds=rng.normal(size=(1, 2, n_af, a.blocks, a.audio_dim)).astype(np.float32),
            seed=args.seed + i, request_id=f"r{i}"))

    kernels = (flash_attention, short_kv_attention_combined_flat, fused_layernorm)
    server = InferenceServer(pipe, dev)
    try:
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        results = [f.result(timeout=1200) for f in [server.submit(r) for r in reqs]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [fn.launches for fn in kernels]
    finally:
        server.close()
    launches.update(B1=counts[0], B3=counts[1], B6=counts[2])
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
    forwards = args.steps * args.requests * (2 if pcfg.cfg_microbatch else 1)
    want = {"B1": c.num_layers * forwards, "B3": a.num_layers * forwards}
    counts_ok = (launches["B1"] == want["B1"] and launches["B3"] == want["B3"]
                 and launches["B6"] >= a.num_layers * forwards)
    ok &= counts_ok
    print(f"serving: {args.requests} requests x {args.steps} steps in {wall:.2f} s wall, "
          f"peak memory {peak:.2f} GiB; launches B1={launches['B1']} (want {want['B1']}) "
          f"B3={launches['B3']} (want {want['B3']}) B6={launches['B6']} "
          f"(want >= {a.num_layers * forwards}) {'ok' if counts_ok else 'FAILED'}", flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2, help="denoise steps per request")
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
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
    print(f"build: {lib.name} (nvcc sm_90a, B1 + B3) and triton import in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = [ln for ln in (lib.parent / "nvcc.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    for line in ptxas:
        print(f"  ptxas: {line.strip()}", flush=True)

    results, launches = {}, {}
    ok = kernel_phase(results)
    ok &= reduced_step_phase()
    if args.requests > 0:
        ok &= serving_phase(args, launches)
    else:
        ok = False
        print("serving phase skipped (--requests 0): no launch counts", flush=True)
    if not ok:
        return _fail("a phase failed")

    meta = {
        "B1": ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
               "bindyouravatar_tpu/ops/flash_attention.py:592"),
        "B3": ("cuda", "bindyouravatar_tpu_torch/csrc/short_kv_attention.cu",
               "bindyouravatar_tpu/ops/short_kv_attention.py:177"),
        "B6": ("triton", "bindyouravatar_tpu_torch/ops/_ln_triton.py",
               "bindyouravatar_tpu/ops/layernorm.py:26"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        err, ms, plain_ms = results[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
