"""Time the VAE's encode of one 49 x 480 x 720 clip on one GPU, with the
ops sliced (the default without autograd) and in one pass each.

    python -m bindyouravatar_tpu_torch.bench_vae_encode [--runs 3] [--frames 49]

Random `VAEConfig()` weights from a seed (fp32 parameters, bf16 compute),
a clip in [-1, 1]; per mode the median wall time of `encode` (synced, after
one warm-up), the peak device memory above the clip and the weights, and
the largest difference of its latents from the same weights computing in
fp32 (convs in TF32, cuDNN's default; sliced, to fit), relative to the
latents' largest magnitude.  The slices change the order of the group
norms' sums and the convs' algorithms, not the function: both modes should
sit at the same distance from fp32.
"""

from __future__ import annotations

import argparse
import time

import torch

from .config import VAEConfig
from .models import vae as vae_mod


def _encode(vae, video, runs: int):
    times, out = [], None
    for i in range(runs + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = vae.encode(video)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    times.sort()
    return out, times[len(times) // 2], peak


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--frames", type=int, default=49)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    vae = vae_mod.CausalVAE.create(VAEConfig(), device=dev, generator=gen)
    video = torch.rand(1, args.frames, 3, 480, 720, device=dev, generator=gen) * 2 - 1
    sliced_at = vae_mod.SLICE_ELEMENTS
    results = {}
    for name, limit in (("sliced", sliced_at), ("one pass", 1 << 62)):
        vae_mod.SLICE_ELEMENTS = limit
        results[name] = _encode(vae, video, args.runs)
    vae_mod.SLICE_ELEMENTS = sliced_at
    fp32 = vae_mod.CausalVAE.create(VAEConfig(dtype=torch.float32), device=dev)
    fp32.load_state_dict(vae.state_dict())
    with torch.no_grad():
        ref = fp32.encode(video)
    del fp32
    for name, (out, seconds, peak) in results.items():
        err = float((out - ref).abs().max()) / float(ref.abs().max())
        print(f"encode {tuple(video.shape)} -> {tuple(out.shape)} bf16 {name}: {seconds:.3f} s, "
              f"peak {peak:.2f} GiB above the clip and weights, max |d| / max |fp32| "
              f"{err:.2e}", flush=True)
    a, b = results["sliced"][0], results["one pass"][0]
    print(f"sliced against one pass: max |d| / max |one pass| "
          f"{float((a - b).abs().max()) / float(b.abs().max()):.2e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
