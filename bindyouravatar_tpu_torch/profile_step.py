"""Where a denoise step's device time goes, on one GPU.

    python -m bindyouravatar_tpu_torch.profile_step [--steps 2] [--face]

Builds the DiT at the 5B serving geometry (random bf16 weights drawn on the
card): audio-only, or with `--face` fully conditioned (face + audio: 21
perceiver injections and router invocations).  Prepares one clip's audio
context (and face tokens), runs one warm-up forward and then `--steps`
batch-2 CFG forwards under `torch.profiler`.  Prints the wall time per
forward, the device time per kernel group (B1 to B6, the router's matrix
products, the other matrix products, the rest) and its share, the
device-busy share of the wall time, and the top kernels by device time.
A matrix product counts as the router's when it was launched inside the
router's modules (norms, layer projections, trunk), which run inside a
`record_function("router")` range during the profile.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch

from .config import DiTConfig
from .models.dit import DiT

# kernel-name substrings per group, first match wins
GROUPS = (("B1 flash_attention", ("flash_fwd_kernel", "prep_qk_kernel")),
          ("B2 short_kv_attention (face)", ("short_kv_attend_kernel",)),
          ("B3 short_kv_attention (audio)", ("short_kv_kernel",)),
          ("B4 pair_axis_attention", ("pair_attention_kernel",)),
          ("B5 tiny_seq_attention", ("tiny_seq_kernel",)),
          ("B6 fused_layernorm", ("ln_fwd_kernel",)),
          ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "sm90")))
ROUTER = "router"


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other (elementwise, norms, copies)"


def _mark_router(dit: DiT) -> None:
    """Run every router module inside `record_function("router")`."""
    open_ranges = []

    def enter(module, inputs):
        rf = torch.profiler.record_function(ROUTER)
        rf.__enter__()
        open_ranges.append(rf)

    def leave(module, inputs, output):
        open_ranges.pop().__exit__(None, None, None)

    for m in (dit.router_norms, dit.router_trunk, *dit.router_layers):
        m.register_forward_pre_hook(enter)
        m.register_forward_hook(leave)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--face", action="store_true",
                   help="the fully conditioned (face + audio) forward")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(args.seed)
    dit = DiT.create(DiTConfig(is_train_face=args.face, dtype=bf, param_dtype=bf), device=dev,
                     generator=gen)
    c, a, lf = dit.cfg, dit.audio_cfg, dit.lfe_cfg
    t, hg, wg = c.latent_grid
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    n_af = c.sample_frames + a.window_size - a.window_stride
    with torch.inference_mode():
        face = {}
        if args.face:
            _mark_router(dit)
            face = dict(id_cond=rnd(2, c.num_ids, lf.id_embed_dim),
                        id_vit_hidden=rnd(2, c.num_ids, lf.num_scales, 577, lf.vit_dim))
        face_emb, actx = dit.prepare_conditioning(
            audio_embeds=rnd(2, 2, n_af, a.blocks, a.audio_dim), **face)
        lat = rnd(2, t, c.in_channels, c.sample_height, c.sample_width)
        txt = rnd(2, c.max_text_seq_length, c.text_embed_dim)
        ts = torch.full((2,), 999.0, device=dev)
        rope = dit.rope(c.sample_height * 8, c.sample_width * 8, t, device=dev)
        step = lambda: dit.apply(lat, txt, ts, rope, audio_ctx=actx, face_emb=face_emb)
        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    # every device activity record once (kernels launched through ctypes or
    # Triton have no aten op above them, so op-level sums would miss them);
    # a kernel is the router's when the CPU op (or range) it is linked to
    # started inside a router range
    events = list(prof.profiler.kineto_results.events())
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    ranges = sorted((e.start_ns(), e.end_ns()) for e in cpu if e.name() == ROUTER)
    cpu_start = {e.correlation_id(): e.start_ns() for e in cpu if e.correlation_id()}
    in_router = lambda ns: any(s0 <= ns <= s1 for s0, s1 in ranges)
    per_group = defaultdict(float)
    per_kernel = defaultdict(float)
    spans = []
    for e in events:
        # the router range's device-side copy is an annotation, not a kernel
        if (e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation()
                or e.name() == ROUTER):
            continue
        us = e.duration_ns() / 1e3
        group = _group(e.name())
        launched = cpu_start.get(e.linked_correlation_id())
        if group == "matrix products" and launched is not None and in_router(launched):
            group = "router matrix products"
        per_group[group] += us
        per_kernel[e.name()] += us
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    launches = len(spans)
    covered, end = 0, 0
    for s, f in sorted(spans):                 # union of the device intervals
        if f > end:
            covered += f - max(s, end)
            end = f
    busy = covered / 1e9
    what = "face + audio" if args.face else "audio-only"
    print(f"{what}, {c.num_layers} layers, {c.max_text_seq_length} + {t * hg * wg} tokens, "
          f"batch 2 (CFG): {wall / args.steps * 1e3:.1f} ms wall per forward; device busy "
          f"{busy / args.steps * 1e3:.1f} ms per forward = {100 * busy / wall:.1f}% of wall; "
          f"{launches // args.steps} kernel launches per forward")
    total = sum(per_group.values())
    for group, us in sorted(per_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:36s} {us / 1e3 / args.steps:9.1f} ms/forward "
              f"{100 * us / total:5.1f}% of device time")
    print("top kernels (ms per forward):")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / args.steps:9.2f}  {name[:110]}")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
