"""Where a denoise step's or a train step's device time goes, on one GPU.

    python -m bindyouravatar_tpu_torch.profile_step [--steps 2] [--face]
    python -m bindyouravatar_tpu_torch.profile_step --train [--steps 2]

Serving: builds the DiT at the 5B serving geometry (random bf16 weights
drawn on the card): audio-only, or with `--face` fully conditioned (face +
audio: 21 perceiver injections and router invocations).  Prepares one
clip's audio context (and face tokens), runs one warm-up forward and then
`--steps` batch-2 CFG forwards under `torch.profiler`.

`--train`: the Stage-3 train step's micro-batch at full width
(`DiTConfig(lora_rank=128, remat=True, remat_policy="nested")`, fp32
weights drawn on the card, batch 1, face + audio): one warm-up and then
`--steps` micro-batches of `Trainer.loss_and_metrics` forward + backward
under the profiler, then one AdamW update timed on its own.

Prints the wall time per forward (micro-batch), the device time per kernel
group (B1 to B14, the router's matrix products, the other matrix products,
the rest) and its share, the device-busy share of the wall time, the
launches, the top kernels by device time and the peak memory.  A matrix
product counts as the router's when it was launched inside the router's
modules (norms, layer projections, trunk), which run inside a
`record_function("router")` range during the profile.  B10's LayerNorm
kernels share B6's and B9's Triton sources and names, so they count in
those groups.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch

from .config import DiTConfig
from .models.dit import DiT

# kernel-name substrings per group, first match wins (the serving step
# launches the flash kernels as B1, the train step as B7)
GROUPS = (("B1 flash_attention", ("flash_fwd_kernel", "prep_qk_kernel")),
          ("B2 short_kv_attention (face)", ("short_kv_attend_kernel",)),
          ("B3 short_kv_attention (audio)", ("short_kv_kernel",)),
          ("B4 pair_axis_attention", ("pair_attention_kernel",)),
          ("B8 tiny_seq_attention backward", ("tiny_seq_bwd_kernel",)),
          ("B5 tiny_seq_attention", ("tiny_seq_kernel",)),
          ("B6 / B10 LayerNorm forward", ("ln_fwd_kernel",)),
          ("B9 / B10 LayerNorm backward", ("ln_bwd_kernel",)),
          ("B11 flash forward (bhsd/bshd) and its pre-pass",
           ("mha_fwd_layout_kernel", "layout_prep_kernel")),
          ("B12 + B13 fused flash backward (bhsd/bshd), its pre- and post-pass",
           ("mha_bwd_kernel", "mha_bwd_pre_kernel", "mha_bwd_post_kernel")),
          ("B14 / B2c / B2h short-KV attention (JAX layouts)", ("skv_layout_kernel",)),
          ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "sm90")))
TRAIN_GROUPS = (("B7 flash forward", ("flash_fwd_kernel",)),
                ("B7 flash backward (fused kernel, pre- and post-pass)",
                 ("flash_bwd_kernel", "flash_bwd_pre_kernel", "flash_bwd_post_kernel")),
                ("B7 q/k pre-pass (forward)", ("prep_qk_kernel",))) + GROUPS[1:]
ROUTER = "router"


def _group(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
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


def _report(prof, wall: float, steps: int, what: str, groups) -> None:
    """Device time per kernel group from the profile, the busy share of
    `wall` and the launches, per step."""
    # every device activity record once (kernels launched through ctypes or
    # Triton have no aten op above them, so op-level sums would miss them);
    # a kernel is the router's when the CPU op it is linked to started
    # inside a router range
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
        group = _group(e.name(), groups)
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
    print(f"{what}: {wall / steps * 1e3:.1f} ms wall per step; device busy "
          f"{busy / steps * 1e3:.1f} ms per step = {100 * busy / wall:.1f}% of wall; "
          f"{launches // steps} kernel launches per step")
    total = sum(per_group.values())
    for group, us in sorted(per_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:40s} {us / 1e3 / steps:9.1f} ms/step "
              f"{100 * us / total:5.1f}% of device time")
    print("top kernels (ms per step):")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / steps:9.2f}  {name[:110]}")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def train_profile(args) -> None:
    """The `--train` profile (see the module docstring)."""
    from .config import SchedulerConfig, TrainConfig
    from .ops.scheduler import Schedule
    from .training.trainer import Trainer

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    dit = DiT.create(DiTConfig(lora_rank=128, remat=True, remat_policy="nested"), device=dev,
                     generator=gen)
    c, a, lf = dit.cfg, dit.audio_cfg, dit.lfe_cfg
    tr = Trainer(dit, Schedule.create(SchedulerConfig()),
                 TrainConfig(lr_warmup_steps=1, grad_accum_steps=1))
    state = tr.init_state()
    t, hg, wg = c.latent_grid
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    lat = lambda: rnd(1, t, c.out_channels, c.sample_height, c.sample_width)
    clean = (torch.arange(wg, device=dev) < wg // 2).float().expand(t, hg, wg).reshape(1, -1)
    clean = torch.stack([clean, 1.0 - clean], -1)
    n_af = c.sample_frames + a.window_size - a.window_stride
    batch = dict(video_latents=lat(), image_latents=lat(), bg_latents=lat(),
                 prompt_embeds=rnd(1, c.max_text_seq_length, c.text_embed_dim),
                 id_cond=rnd(1, c.num_ids, lf.id_embed_dim),
                 id_vit_hidden=rnd(1, c.num_ids, lf.num_scales, 577, lf.vit_dim),
                 audio_embeds=rnd(1, 2, n_af, a.blocks, a.audio_dim),
                 teacher_clean=clean, teacher_noisy=clean, dense_mask=torch.ones(
                     1, t, c.sample_height, c.sample_width, device=dev))
    _mark_router(dit)
    micro = lambda: tr.grads_and_metrics(batch, generator=gen)
    grads, _ = micro()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            grads, _ = micro()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, wall, args.steps,
            f"train micro-batch (forward + backward, batch 1, face + audio, LoRA r128, nested "
            f"checkpointing), {c.num_layers} layers, {c.max_text_seq_length} + {t * hg * wg} "
            f"tokens", TRAIN_GROUPS)
    t0 = time.perf_counter()
    tr.apply_gradients(state, grads)
    torch.cuda.synchronize()
    print(f"AdamW update over {sum(p.numel() for p in tr.trainable.values()) / 1e9:.3f}B "
          f"trainable parameters ({len(tr.trainable)} tensors): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--face", action="store_true",
                   help="the fully conditioned (face + audio) forward")
    p.add_argument("--train", action="store_true",
                   help="the Stage-3 train step's micro-batch, forward + backward")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    if args.train:
        return train_profile(args)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(args.seed)
    dit = DiT.create(DiTConfig(is_train_face=args.face, dtype=bf, param_dtype=bf,
                               fuse_qk_norm=True), device=dev, generator=gen)
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

    what = "face + audio" if args.face else "audio-only"
    _report(prof, wall, args.steps,
            f"{what}, {c.num_layers} layers, {c.max_text_seq_length} + {t * hg * wg} tokens, "
            f"batch 2 (CFG) forward", GROUPS)


if __name__ == "__main__":
    main()
