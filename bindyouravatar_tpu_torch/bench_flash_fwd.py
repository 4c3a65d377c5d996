"""Time the flash attention forward (B1, B7's forward, B11) on one GPU at the
main paths' shapes, each call held against its plain version.

    python -m bindyouravatar_tpu_torch.bench_flash_fwd [--runs 5] [--no-check]

Builds the kernels of the tree it runs in (so two trees, unpacked side by
side, compare two versions in one call), prints the compiler's register
and spill report for the forward's kernels, then one line per call: the
median of CUDA events around the wrapper (`event_ms`), the kernels' own
time from profiler device records, pre-pass and forward summed
(`kernel_ms`), SDPA's time both ways where one PyTorch call computes the
same function (`sdpa_ms`), the bound (4 S^2 D FLOP per head at 989
TFLOP/s bf16) and the largest error against the plain version, relative
to the plain output's largest magnitude.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from .ops import _build
from .ops import flash_attention as fa
from .ops.rope import get_3d_rotary_pos_embed
from .profile_step import kernel_ms

# (name, layout, B, S, H, D, rope rows start (or None), QK-LN, LSE)
CASES = (("B1 fused [2,17776,3072] LN+RoPE", "flat", 2, 17776, 48, 64, 226, True, False),
         ("B1 bare [52,1350,512]", "flat", 52, 1350, 8, 64, None, False, False),
         ("B1 bare [2,17776,3072]", "flat", 2, 17776, 48, 64, None, False, False),
         ("B7 fwd [1,17776,3072] RoPE, LSE", "flat", 1, 17776, 48, 64, 226, False, True),
         ("B7 fwd bare [26,1350,512], LSE", "flat", 26, 1350, 8, 64, None, False, True),
         ("B11 bare bhsd [2,48,17776,64]", "bhsd", 2, 17776, 48, 64, None, False, True),
         ("B11 bshd [2,17776,48,64] LN+RoPE", "bshd", 2, 17776, 48, 64, 226, True, True),
         ("B11 D=128 bhsd [1,24,17776,128] RoPE", "bhsd", 1, 17776, 24, 128, 226, False, True))


def _events_ms(fn, runs: int) -> float:
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _fmt(ms) -> str:
    return "none" if ms is None else f"{ms:.4f}"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--no-check", action="store_true", help="skip the plain versions")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_fwd needs a CUDA device")
    lib = _build.build_cuda()
    _build.cuda_lib()
    log = (lib.parent / "nvcc.log").read_text().split("== ")
    for part in log:
        if part.startswith("flash_attention.cu"):
            for line in part.splitlines():
                if "registers" in line or "spill" in line or "wgmma" in line or "error" in line:
                    print(f"ptxas: {line.strip()}")
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(5)
    rnd = lambda *shape, std=1.0, mean=0.0: (
        torch.randn(shape, generator=gen, device=dev) * std + mean)
    for name, layout, b, s, h, d, rope_start, ln, want_lse in CASES:
        shape = {"flat": (b, s, h * d), "bhsd": (b, h, s, d), "bshd": (b, s, h, d)}[layout]
        q, k, v = (rnd(*shape).to(bf) for _ in range(3))
        kw = {}
        if rope_start is not None:
            kw.update(rope=get_3d_rotary_pos_embed(d, ((0, 0), (30, 45)), (30, 45), 13,
                                                   device=dev), rope_start=rope_start)
        if ln:
            kw["qk_norm"] = (rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1),
                             rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1))
        if layout == "flat" and want_lse:
            kern = lambda: fa.flash_attention_flat_fwd(q, k, v, h, **kw)[0]
            plain = lambda: fa.flash_attention_flat_fwd_plain(q, k, v, h, block_q=512, **kw)[0]
        elif layout == "flat":
            kern = lambda: fa.flash_attention(q, k, v, h, **kw)
            plain = lambda: fa.flash_attention_plain(q, k, v, h, block_q=512, **kw)
        else:
            kern = lambda: fa.flash_attention_fwd(q, k, v, layout, **kw)[0]
            plain = lambda: fa.flash_attention_fwd_plain(q, k, v, layout, block_q=512, **kw)[0]
        err = "not checked"
        if not args.no_check:
            got, want = kern().float(), plain().float()
            err = f"{float((got - want).abs().max()) / float(want.abs().max()):.3e} of max|ref|"
            del got, want
        sdpa = "none"
        if rope_start is None and not ln:
            qb, kb, vb = (t.reshape(b, s, h, d).transpose(1, 2).contiguous() if layout == "flat"
                          else t for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qb, kb, vb)
            sdpa = f"{_events_ms(lib, args.runs):.4f} (kernel {_fmt(kernel_ms(lib, args.runs))})"
        bound = 4.0 * b * h * s * s * d / 989e12 * 1e3
        print(f"{name}: event_ms={_events_ms(kern, args.runs):.4f} "
              f"kernel_ms={_fmt(kernel_ms(kern, args.runs))} "
              f"sdpa_ms={sdpa} bound_ms={bound:.4f} "
              f"rel_err={err}", flush=True)
        del q, k, v


if __name__ == "__main__":
    main()
