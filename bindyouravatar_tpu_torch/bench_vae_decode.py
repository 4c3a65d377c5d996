"""Time the VAE's decode of one clip's latents on one GPU, whole and in
chunks of 4 latent frames (what a streamed request decodes), with the peak
device memory above the weights and the latents.

    python -m bindyouravatar_tpu_torch.bench_vae_decode [--frames 49 97 193] [--runs 1]
        [--save DIR | --compare DIR]

Random bf16 weights from a seed for the serving pipeline's two models,
the 42-layer face + audio DiT held beside the VAE as a server holds it
while it decodes; fp32
latents [1, T, 16, 60, 90] (as the server hands them over) at T = (frames
- 1) / 4 + 1, 480 x 720 pixels.  Per length and mode: the median wall time
of `decode` (synced, after one warm-up) and its peak.  A whole decode that
does not fit on the card is reported as such, with the memory the
allocator had reached when it refused, and the chunked decode still runs:
whether a length fits is what this measures.  `--save DIR` writes each
whole decode (fp32 .npy); `--compare DIR`, run with the same seed (the
same weights and latents) by another version of the package, holds each
whole decode against the one saved there (relative L2, largest |d|).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .config import DiTConfig, VAEConfig
from .models.dit import DiT
from .models.vae import CausalVAE


def _decode(vae, lat, chunk, runs: int, keep: bool = False):
    """('<s> s, peak <GiB> GiB' of `runs` decodes after a warm-up, or the
    out-of-memory reading; the last decode on the host if `keep`, else
    None)."""
    times, peak, kept = [], 0.0, None
    for i in range(runs + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                out = vae.decode(lat, temporal_chunk=chunk)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            reached = (torch.cuda.max_memory_allocated() - base) / 2**30
            torch.cuda.empty_cache()
            first = str(e).splitlines()[0]
            return (f"does not fit: out of memory after {reached:.2f} GiB above the weights "
                    f"and latents ({first})", None)
        if i:
            times.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        if keep and i == runs:
            kept = out.cpu().numpy()
        del out
    times.sort()
    return (f"{times[len(times) // 2]:.3f} s, peak {peak:.2f} GiB above the weights and latents",
            kept)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, nargs="+", default=[49, 97, 193])
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", metavar="DIR", help="write each whole decode here (fp32 .npy)")
    p.add_argument("--compare", metavar="DIR",
                   help="hold each whole decode against the one --save wrote here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_vae_decode needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    bf = torch.bfloat16
    dit = DiT.create(DiTConfig(dtype=bf, param_dtype=bf), device=dev, generator=gen)
    vae = CausalVAE.create(VAEConfig(param_dtype=bf), device=dev, generator=gen)
    card = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"{torch.cuda.get_device_name(0)}: DiT ({dit.cfg.num_layers} layers) and VAE weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, card {card:.2f} GiB", flush=True)
    for frames in args.frames:
        t = (frames - 1) // vae.cfg.temporal_compression_ratio + 1
        lat = torch.randn((1, t, vae.cfg.latent_channels, 60, 90), generator=gen, device=dev)
        for name, chunk in (("whole", None), ("chunks of 4 latent frames", 4)):
            keep = chunk is None and bool(args.save or args.compare)
            line, video = _decode(vae, lat, chunk, args.runs, keep)
            print(f"decode {frames} x 480 x 720 (T = {t}), {name}: {line}", flush=True)
            if video is None:
                continue
            path = os.path.join(args.save or args.compare, f"decode_{frames}.npy")
            if args.save:
                os.makedirs(args.save, exist_ok=True)
                np.save(path, video)
            elif os.path.exists(path):
                ref = np.load(path)
                d = video.astype(np.float64) - ref
                rel = float(np.linalg.norm(d) / np.linalg.norm(ref))
                print(f"  whole decode of {frames} frames against {path}: relative L2 {rel:.3e}, "
                      f"largest |d| {float(np.abs(d).max()):.3e} of largest |ref| "
                      f"{float(np.abs(ref).max()):.3e}, bitwise equal "
                      f"{bool(np.array_equal(video, ref))}", flush=True)
        del lat
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
