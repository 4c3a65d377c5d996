#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py     # 42 layers; serving requests of 2 steps each; 2 optimizer steps
                              # of the Stage-3 train step (4 layers); the sft launcher: 2
                              # steps, a checkpoint, a resume and a third step; a 10-step
                              # clip; the CLI (also two-stage, and from reference-format
                              # files); SAM2 and the upscaler; 97-, 193- and 801-frame clips
    python3 chip_smoke.py --only-kernels B2,B3,B6   # phase 2 of these kernels only
    python3 chip_smoke.py --only-kernels dh16,dsweep  # phase 2's rows of a head-dim class
    python3 chip_smoke.py --only-kernels widths    # the short-KV and packed kernels' widths
    python3 chip_smoke.py --only-distribution      # phase 11 only
    python3 chip_smoke.py --only-head-dims         # phases 3g and 3h only
    python3 chip_smoke.py --only-kernels tokens    # the short-KV kernels at other K and I
    python3 chip_smoke.py --only-tokens            # phase 3i only
    python3 chip_smoke.py --face-plain             # ROADMAP C5: the face path's kernels
                                                   # swapped for plain fp32 versions
    python3 chip_smoke.py --only-long-clips        # phase 12 only
    python3 chip_smoke.py --only-kernels stream    # phase 2's streamed B5 / B5' / B8 rows

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
     at M = 1,001 for S = 8, 13, 16 and on the long body for S = 17, 24,
     25, 31, 32, 33, 48, 64, 129 and 192; B8 and B9 run twice, bitwise
     equal; B5 and B5', timed, at M = 1,001 for S = 1, 2, 7, 8, 9, 13, 16
     and at M = 5, and B5 run twice at its main shapes, bitwise equal; B5
     and B8 at 81 and 97 frames ([5400 | 2700, 21 | 25, 512], timed), B5
     untimed at B8's long lengths, B5' at 17 and 25; the 2B
     variant's instantiations: B1 with the fused QK-LN and no RoPE at
     [2, 17776, 1920] (30 heads) and ragged, B2 at 16 x 80 heads (the
     kernel's loads fill columns 80-127 with zeros), B6 at width 1920; B1
     with QK-LN + RoPE at [2, 17776, 3072] and B7's forward and backward
     with RoPE at [1, 17776, 3072] as 96 x 32 and 24 x 128 heads, and each
     ragged at [1, 1000, 3072] with kv_len 937, SDPA on B7's q/k/v
     without RoPE beside them; the head dims the flash kernels and B10
     took last, each class a name of its own for `--only-kernels` (dh16,
     dh48, dh96, dh256; dh32, dh64, dh128: B10's; dsweep): B11 and
     B12 + B13 at bshd and bhsd [1, 17776, 3072] as 192 x 16, 64 x 48, 32 x
     96 and 12 x 256 heads with RoPE, B7 forward and backward at 192 x 16
     and 12 x 256 heads with RoPE, each with SDPA on the same q/k/v without
     RoPE beside it, B1 and B7 bare at the STAB's [52, 1350, 512] as 2 x
     256 heads against SDPA, B10 forward and backward at segments of 16,
     32, 48, 96, 128 and 256 on [17776, 3072] (timed) and at phase 3f's
     widths (3,024 as 189 x 16, 3,008 as 47 x 64), and every D % 8 == 0
     from 8 to 256 at [1, 1100, 3, D] with kv_len 1,000 (bshd with RoPE,
     forward also with the QK-LN; bhsd bare; flat B1 and B7 at the dims
     whose heads pack), untimed; the short-KV and packed kernels at the
     widths they took last (`widths`, and by dh class), timed at their
     paths' shapes: B3 at [26, 1350, 3072] as 192 x 16, 96 x 32, 24 x 128
     and 12 x 256 heads, B2, B14, B2c and B2h at D = 48 and 256, B5, B5'
     and B8 at dh 32, 48 and 128, B4 at 16 x 32, 4 x 128 and C = 384; and
     untimed at their hazards: every short-KV entry point at D = 16, 32,
     48, 64, 128, 256 over Sq = 1,000 in 3 batches at I = 1, 2, 4 and
     combined at [26, 1350] as 16 x 128, 192 x 16 and 12 x 256 heads;
     B5 / B5' and B8 (twice, bitwise) at M = 1,001 at dh 8, 32, 48, 128,
     256 from S = 1 to each width's long-body cap; B4 at 1,001 rows from
     25 x 8 to 24 x 128 and JAX's 128 heads; the short-KV kernels at other
     token and identity counts (`tokens`): B3 at [26, 1350, 3072] with
     (K, I) = (16, 2), (64, 2), (32, 5), (32, 8), (64, 5) and B2 at q [2,
     17550, 2048] with (16, 2), (64, 2), (32, 3), (32, 5), timed, and every
     short-KV entry point, untimed, at K = 1, 4, 8, 16, 24, 33, 64, 100 and
     I = 1, 3, 5, 8 at D = 64, 128, 256 (16 and 48 at K = 100, I = 5) over
     Sq = 1,000 in 3 batches, its K/V resident or streamed); B5, B5' and
     B8 on the streamed body (`stream`), timed: one past each body's cap
     ([1001, 193, 8 x 64], [1001, 97, 4 x 128], [1001, 49, 2 x 256]), at
     S = 201 and 400 over M = 1,001, and at [5400, 400, 512] (past 2^31
     bytes), the plain versions 256 rows at a time, B5 and B8 twice at S
     = 201 and 49, bitwise equal, B11's bshd forward on the same memory
     timed beside each B5 row (the yardstick), and B5 untimed where an
     item's K and V pass the forward's shared memory (they stream);
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
  3e. a 2-layer DiT at full width (dim 3072) with 24 x 128 and with 96 x
     32 heads, audio only, 16 + 1,024 tokens: the serving forward (B1
     fused) and one Stage-3 micro-batch (B7, B10 at the head dim) on the
     card against the CPU in fp32 (forward within 2%, gradients within 3%
     relative L2), exact launch counts; its B1 and B7 launches are the
     kernels line's `dh32` / `dh128` rows'.
  3f. the same at 192 x 16 (flat B7), 12 x 256 (flat B7 on the 256-column
     bodies), 189 x 16 (dim 3,024: B11 and B12 + B13 at D = 16) and 47 x
     64 heads (dim 3,008: the unpaired-head DiT at full width), each with
     B10 at its head dim and no fused B1 at inference (JAX's module takes
     it at 32, 64 and 128 only); its launches are the kernels line's `dh16`
     / `dh256` rows'.
  3g. the face + audio DiT that `DiT.create` builds, its audio layers'
     heads derived (the DiT's own: B3 at its dh), 2 layers at dim 3072,
     16 + 1,024 tokens, at 24 x 128, 96 x 32, 192 x 16 and 12 x 256 heads,
     then at 24 x 128 with the router's STAB at 4 x 128 and 16 x 32 heads
     (B5, B8 and B4 at dh 128 and 32): the serving forward and one Stage-3
     micro-batch against the CPU in fp32 (forward within 2%, gradients
     within 3%, the face path's within phase 3b's 10%), exact launches;
     then one request at `--request-layers` (8: the 5B's 42 cut for the
     smoke's time) with 24 x 128
     heads, face + audio, 49 frames, 2 steps, through the `InferenceServer`
     (s a denoise step,
     peak, launches); the kernels line's B3 / B4 / B5 / B8 width rows.
  3h. the short-KV and packed entry points at the widths no model of the
     smoke reaches (B2, B14, B2c, B2h at D = 48 and 256; B5 and B8 at 8 x
     48 heads; B5' at dh 32, 48, 128; B4 at C = 384), once each against
     their plain versions, one launch each: the rest of the width rows.
  3i. `DiT.create`'s face + audio DiT at other token and identity counts, 2
     layers at dim 3072 (48 x 64 heads, the audio heads derived), 16 +
     1,024 tokens, with (I, K_f face, K_a audio tokens) = (3, 24, 16), (5,
     56, 64) and (2, 8, 4): B2 at K_f and B3 at K_a on their general key
     blocks, the multi-ID STAB on B5' (I = 3, 5) or B4 (I = 2); the serving
     forward and one Stage-3 micro-batch against the CPU in fp32 at 3g's
     tolerances, exact launches; then one request at `--request-layers`
     (8) with I = 5,
     K_f = 56, K_a = 64 through the `InferenceServer` (s a denoise step,
     peak, launches); then each token row's configuration once through its
     entry point (one launch each: the token rows' launches).
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
     checkpointing), 4 layers (`--train-layers`, cut from 42 so that
     the smoke, phases 3g and 12 included, ends inside its 1,200 s on a
     host whose CPU is slow too: phases 5, 5b, 5c and 11's steps scale with
     it; 4 layers hold every kind of layer the step runs): finite metrics, moved
     trainable and bit-identical frozen tensors, exact launch counts, peak
     memory.
  5b. the same model, weights and batch: one optimizer step's
     micro-batches (gradients, no update) under remat_policy="save_attn"
     against "nested" with the same draws: loss within 1e-3 relative,
     every trainable gradient within 10% relative L2, exact launch counts
     of both (the joint attention's forward once per block under
     "save_attn"), peak memory and wall of both.
  5c. the same model and batch: one optimizer step each of adafactor,
     prodigy and 8-bit AdamW, each from phase 5's trainable tensors with
     the same draws (seconds, peak, the state's bytes, launches;
     the update of five stacked leaves against the same optimizer on the
     CPU in fp32), two prodigy steps with those leaves as the trainable set
     (d and its numerator against the CPU's; d grows at step 2), then one
     micro-batch at `ff_chunks=4` beside
     `ff_chunks=1` (seconds, peak, gradients within 5% relative L2).
  6. the port's training entry point at the 5B geometry, after phase 5's
     model is freed: `training.sft.main` in this process, `--model_size
     5b --remat_policy nested --use_8bit_adam --index_file <2 samples of
     49 x 480 x 720 written here> --num_validation_videos 1
     --validation_steps 2`, 4 layers with widths full (`--driver-layers`;
     a save at 42 layers writes 32.4 GB of state and
     sub-modules, the phase saves twice, and the card's machine stops a run
     after 45 GiB of writes, of which 7e takes 18 GB), synthetic 49 x 480 x 720
     clips encoded by the VAE, teacher masks, the driver: 2 optimizer
     steps and a checkpoint into a temporary directory, then `--max_train_steps 3
     --resume latest`: the restored trainable tensors, 8-bit AdamW state,
     sampler and generator states equal the saved ones, step 3 runs, a
     validation mp4 at steps 2 and 3,
     `metrics.jsonl` holds 3 finite rows, the frozen tensors are
     bit-identical and each run's launch counts are exact; per step the
     `prepare_batch` and step seconds and peak memory, the checkpoint's
     bytes and its save and restore seconds, and the free disk.
  7. after phase 6 frees its model: one face + audio request through the
     `InferenceServer` on a new 42-layer 5B model, `--clip-steps` (10; a
     shipped clip takes 50) DPM++ steps, guidance 6, 49 x 480 x 720, whole
     decode, weights and conditioning drawn on the card: finite [1, 49, 3, 480, 720], exact
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
  7e. the CLI's `run` from reference-format files of a drawn 42-layer 5B
     model (another seed than the run's): the base transformer as bf16
     safetensors in 3 shards, the three sub-module `.pt` files under the
     reference's names and layouts, a peft r128 q/k LoRA and a
     diffusers-named VAE file, through `--reference_transformer`,
     `--reference_{audio,face,router}_modules` and `--lora_path` with 7c's
     inputs: every DiT tensor equals the drawn one bit for bit (q/k: drawn
     + the LoRA delta, computed here in fp32 and cast), launches are 7c's,
     the clip equals `generate` on a pipeline given the same tensors
     directly, bit for bit, and `import_vae` of the VAE file gives the
     drawn VAE; the bytes written, each group's read seconds, the peak
     device memory beside 7c's and the host's peak RSS.
  8. the conditioning encoders at full size, bf16 weights drawn on the
     card: T5-XXL's encoder on 2 x 226 tokens, EVA02-CLIP-L-336, IR-100,
     RetinaFace-R50 on a 480 x 720 image, BiSeNet at 512: shapes,
     finiteness, ms and peak; at 2 blocks (T5, EVA-CLIP) or whole (the
     CNNs) against the CPU in fp32 on the same weights.  None of them
     launches a kernel: JAX's twins reach no Pallas kernel.  Then
     wav2vec2-base (94 M, drawn, written as an HF directory and read back)
     on 10 s of 16 kHz audio to [250, 12, 768], fp32 with TF32 off, and at
     2 layers against the CPU.
  9. SAM2 at `sam2.1_hiera_large` (image 1024) and RRDBNet at
     `RealESRGAN_x4plus`, fp32 weights drawn on the card: the image
     encoder's ms a frame, `propagate_in_video` over 49 x 480 x 720 with 2
     objects (the bank full at 7 memories + 16 pointers), `tiled_scale`
     (512 tiles, overlap 32) on one 480 x 720 frame, peaks; each against
     the CPU in fp32 at reduced depth.  Neither launches a kernel: JAX's
     SAM2 and RRDBNet reach no Pallas kernel.
  10. the 2B variant at CogVideoX-2B's widths (30 layers, 30 x 64 heads,
     sincos positions) with the avatar's face + audio layout: one request
     of 2 steps at 49 x 480 x 720 through `pipeline.generate` in bf16
     (s a step, peak, exact launches), and 2 layers on the card against
     the CPU in fp32.
  11. distribution and the profiling helpers, after every other phase (so
     their launch counts are unchanged).  The card has one GPU and NCCL
     takes one rank a device, so the multi-rank paths run here at world
     size 1 (their multi-rank checks run on the CPU over gloo, in the
     tests).  The ring's per-block function (`ring_block`, `ring_merge`:
     kernel B7's forward per block, merged by LSE) over every (rank, step)
     pair of sp 2 and sp 4 at [2, 17776, 3072] bf16 padded to 17,920, and
     at 300 tokens (sp 4: the last shard all padding, its blocks skipped),
     against B7's unsharded forward with kv_len = the real rows (phase 2's
     tolerance), ms a block step and in all beside the unsharded call; B1
     and B3 at the TP plan's 24 heads a rank at tp 2 against their plain
     versions; then an NCCL group of world size 1: the sequence-parallel
     2-layer full-width `DiT.apply` (the ring of 1) against the fused B1
     path and against the blocks' training path (B10, then B7 with RoPE
     inside: the witness of the roundings of two correct paths), within
     twice their spread in relative L2, launches B1 -> B7 forward + B10
     per block; the TP-planned forward (`shard_params_tp` wraps its
     modules over the one rank) against the unsharded one (bit for bit or
     not, launches equal); `trace()` and `PhaseTimer` around a forward (the
     trace file names the kernels' symbols); and phase 5's Stage-3 step
     (AdamW, 2 micro-batches, rebuilt from its seeds at its depth)
     unsharded again (B7's backward adds dq in no fixed order: the floor)
     and through `shard_params` (`fully_shard` over the one rank): the
     trainable change within relative L2 1e-2 of phase 5's, frozen tensors
     bit-identical, launches equal phase 5's, step walls and peaks beside
     phase 5's, and the extra peak parted into the root unit's gathered
     copy (read at the root's forward) and the rest; then adafactor and
     8-bit AdamW sharded so, phase 5c's step from its start and draws,
     against it, and prodigy (2 steps, lr 10, at 8 layers: 42 do not fit
     sharded) sharded and unsharded, each within relative L2 1e-2 of the
     trainable change.  The group is destroyed at the end.
  12. long clips (the router's temporal STAB attention over T latent
     frames: B5 / B8's long body to each body's cap, the streamed body
     past it).  12a, on phase 4's model: one face + audio request through
     the `InferenceServer` at 97 x 480 x 720 (T = 25), 2 steps, streamed in
     chunks of 4 latent frames: [1, 97, 3, 480, 720], seconds a step,
     `decode_s`, peak, exact launches, B5 dispatched on the long body at S
     = 25 only and no plain version called; 12d, on the same model: one
     request at 801 x 128 x 192 (T = 201, 226 + 19,296 tokens), whole
     decode, B5 on the streamed body at S = 201 only (84 launches a
     forward).  12b (after phase 10): 7c's flow at `--num_frames 193` (T =
     49, 226 + 66,150 tokens), decoded whole: the meta line's seconds,
     wall, peak, launches, B5 at S = 49.  12c: a 2-layer DiT at the 5B
     widths (48 x 64 heads, its audio layers, router and LFE full width),
     face + audio, T = 25 on a 12 x 18 latent grid: the serving forward
     within 2% and one Stage-3 micro-batch's gradients within 3% relative
     L2 of the CPU's fp32 (the face path's within phase 3b's 10%), B5 and
     B8 at S = 25 inside the model, exact launches; then the same at 49
     frames (T = 13, the one-tile bodies) as the control, its errors
     printed beside; then on the streamed body on a 4 x 6 latent grid: T =
     201 with the 8 x 64 STAB heads and T = 49 with 2 x 256 (cap 48); and
     B5' streamed once through `packed_head_attention` [1001, 201 x 8, 64].
The CPU's fp32 references of the 2-layer DiT cases of phases 3e to 3i and
12c run on a worker thread of their own (`_References`) while the card goes
on with phases 4 to 12b: each case's card side runs when it is started
between two phases, its line prints when its reference is done, and every
verdict is in before phase 11 (phase 7e, which reads the host's RSS, runs
with none in flight).  A line after each group of phases gives its seconds
and the seconds since the start.
Then a JSON line with the kernels, and as the last line the device JSON.
There is no CPU fallback: without a CUDA device it fails at once.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
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


# phase 2's lengths past 16 rows (the long body) besides `MAX_S`: one row
# into a second tile (17), 97 frames (25), a full last tile (32, 48, 64),
# one row into a third (33) and a ninth (129) tile
LONG_S = (17, 24, 25, 31, 32, 33, 48, 64, 129)


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

    def report(name, tag, got, want, atol, rtol, kern, plain, runs, library=None, work=None,
               plain_ms=None):
        """Compare, time kernel / plain / library call; `work` = (bytes,
        flops, peak kind) of the call for its bound.  The kernel and the
        library call are timed twice: CUDA events around the call (`ms`,
        `library_ms`) and the kernels' own time from profiler device
        records (`kernel_ms`: `kernel_records_ms`, `library_records_ms`),
        which leaves out the host time that events around a
        sub-millisecond call take in while the card waits."""
        nonlocal ok_all
        err, rel, ok = _compare(got, want, atol, rtol)
        ms = _time_ms(kern, runs)
        if plain_ms is None:     # else the caller timed the call that made `want`
            # no warmup: the call that made `want` warmed the plain version
            plain_ms = _time_ms(plain, max(1, runs // 2), warmup=0)
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

    def report_all(name, tag, gots, wants, rels, kern, plain, runs, library, work,
                   plain_ms=None):
        """One line per output (first one timed), each within `rel` of the
        reference's largest magnitude (+ `rel` relative); ok only if all
        agree."""
        nonlocal ok_all
        r = None
        for i, (got, want, rel) in enumerate(zip(gots, wants, rels)):
            sub = f"{tag} out{i}"
            if i == 0:
                r = report(name, sub, got, want, _rel_compare(got, want, rel), rel, kern, plain,
                           runs, library, work, plain_ms)
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
    # The 2B variant's form: QK-LN fused, no RoPE, 30 heads (15 head pairs)
    # at [2, 17776, 1920], and ragged beside it.
    for tag, b, s, h, text_len, grid, kv_len, mag in pick((
            ("slice[2,17776,3072]", 2, 17776, 48, 226, (13, 30, 45), None, 1.0),
            ("ragged[1,1000,512] kv_len=937", 1, 1000, 8, 10, (3, 18, 18), 937, 1.0),
            ("2b[2,17776,1920] QK-LN no RoPE", 2, 17776, 30, 226, "ln", None, 1.0),
            ("2b ragged[1,1000,1920] kv_len=937 QK-LN no RoPE", 1, 1000, 30, 10, "ln", 937, 1.0),
            ("bare[52,1350,512] no LN/RoPE", 52, 1350, 8, 0, None, None, 1.0),
            ("ragged[2,777,256] no LN/RoPE", 2, 777, 4, 0, None, None, 1.0),
            ("ragged[2,1350,512] kv_len=1000 no LN/RoPE", 2, 1350, 8, 0, None, 1000, 1.0),
            ("large[4,1350,512] q,k x8 no LN/RoPE", 4, 1350, 8, 0, None, None, 8.0)), ["B1"]):
        q, k, v = (rnd(b, s, h * 64, std=mag if i < 2 else 1.0).to(bf) for i in range(3))
        kw = dict(kv_len=kv_len)
        library = None
        if grid is not None:
            norm = (rnd(64, std=0.1, mean=1.0), rnd(64, std=0.1),
                    rnd(64, std=0.1, mean=1.0), rnd(64, std=0.1))
            kw.update(qk_norm=norm)
            if grid != "ln":
                kw.update(rope=get_3d_rotary_pos_embed(64, ((0, 0), grid[1:]), grid[1:], grid[0],
                                                       device=dev), rope_start=text_len)
        else:
            qb, kb, vb = bhsd(q, h), bhsd(k, h), bhsd(v, h)
            library = lambda: F.scaled_dot_product_attention(qb, kb, vb)
        kern = lambda: fa.flash_attention(q, k, v, h, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, h, block_q=512, **kw)
        work = (_nbytes(q, k, v, q), 4.0 * b * h * s * (kv_len or s) * 64, "bf16")
        r = report("B1", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 5, library, work)
        if tag.startswith(("slice", "bare", "2b[")):
            results[{"s": "B1", "b": "B1 bare", "2": "B1 2b"}[tag[0]]] = r

    # --- B1 at the other flat head dims, 96 x 32 and 24 x 128 heads at width
    # 3072 (the dh-64 rows' FLOPs: the bound does not depend on the head
    # dim), QK-LN + RoPE, and ragged (1,000 rows, kv_len 937).  D = 32 runs
    # the 64-column tiles, the TMA boxes reading columns 32-63 as zeros.
    # tol: as the dh-64 rows.  No library call applies the QK-LN and RoPE.
    for d, (tag, b, s, text_len, grid, kv_len) in pick(
            [(d, row) for d in (32, 128) for row in (
                (f"slice[2,17776,3072] dh{d}", 2, 17776, 226, (13, 30, 45), None),
                (f"ragged[1,1000,3072] kv_len=937 dh{d}", 1, 1000, 10, (3, 18, 18), 937))],
            ["B1"]):
        h = 3072 // d
        q, k, v = (rnd(b, s, 3072).to(bf) for _ in range(3))
        norm = (rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1), rnd(d, std=0.1, mean=1.0),
                rnd(d, std=0.1))
        kw = dict(kv_len=kv_len, qk_norm=norm, rope_start=text_len,
                  rope=get_3d_rotary_pos_embed(d, ((0, 0), grid[1:]), grid[1:], grid[0],
                                               device=dev))
        kern = lambda: fa.flash_attention(q, k, v, h, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, h, block_q=512, **kw)
        work = (_nbytes(q, k, v, q), 4.0 * b * s * (kv_len or s) * 3072, "bf16")
        r = report(f"B1 dh{d}", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 3, None, work)
        if tag.startswith("slice"):
            results[f"B1 dh{d}"] = r
        del q, k, v

    # --- B2: perceiver face attention, q [2, 17550, 16*128], k/v [2, 2, 16, 32,
    # 128], one output per identity; ragged Sq=1000.
    # tol: the plain version rounds p and each output to bf16 as the kernel
    # does; fp32 sums in another order.
    # library: SDPA with the identities folded into the heads (q repeated
    # per identity before timing), output [B, I*H, Sq, 128].
    # The 2B variant's router: 16 heads of 80 (q_k_dim 1280), read by the
    # kernel's 128-wide body through tensor maps 80 wide.
    for tag, b, sq, d in pick((("slice[2,17550,2048] I=2 K=32", 2, 17550, 128),
                               ("ragged[1,1000,2048] I=2 K=32", 1, 1000, 128),
                               ("2b[2,17550,1280] I=2 K=32 D=80", 2, 17550, 80)), ["B2"]):
        q = rnd(b, sq, 16 * d).to(bf)
        k, v = (rnd(b, 2, 16, 32, d).to(bf) for _ in range(2))
        kern = lambda: skv.short_kv_attention_flat(q, k, v, d ** -0.5)
        plain = lambda: skv.short_kv_attention_flat_plain(q, k, v, d ** -0.5)
        qi = bhsd(q, 16).unsqueeze(1).expand(b, 2, 16, sq, d).reshape(b, 32, sq, d)
        ki, vi = k.reshape(b, 32, 32, d), v.reshape(b, 32, 32, d)
        library = lambda: F.scaled_dot_product_attention(qi, ki, vi)
        work = (_nbytes(q, k, v) + 2 * _nbytes(q), 4.0 * b * 2 * 16 * sq * 32 * d, "bf16")
        r = report("B2", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 20, library, work)
        if tag.startswith(("slice", "2b")):
            results["B2" if tag.startswith("slice") else "B2 2b"] = r

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

    # --- B5: temporal STAB attention [5400, 13, 8*64] (49 frames); at 81 and
    # 97 frames [5400, 21, 512] and [5400, 25, 512] on the long body (rows
    # "B5 S21", "B5 S25"); ragged M=1001.  B5': the same kernel for S < 8
    # through `packed_head_attention` on the packed [M, S*8, 64] view, at S =
    # 3 (the reduced step's frames) and 2.  Then every kind of tile the
    # kernel makes: at M = 1,001 S = 1, 2, 7 (16 / S items packed in a tile,
    # the last tile part empty) and 8, 9, 16 (one item a tile: 8 or 7 pad
    # rows, none); and M = 5 (fewer tiles than resident warps) at S = 13
    # and 3.
    # tol: both sides round p to bf16; fp32 sums in another order.
    # library: SDPA on a [M, 8, S, 64] copy (permuted before timing).
    b5_rows = [("B5", "slice[5400,13,512]", 5400, 13), ("B5", "ragged[1001,13,512]", 1001, 13),
               ("B5 S21", "slice[5400,21,512]", 5400, 21),
               ("B5 S25", "slice[5400,25,512]", 5400, 25),
               ("B5'", "slice[5400,3,512]", 5400, 3), ("B5'", "slice[5400,2,512]", 5400, 2)]
    b5_rows += [("B5" if s >= 8 else "B5'", f"ragged[1001,{s},512]", 1001, s)
                for s in (1, 2, 7, 8, 9, 16)]
    b5_rows += [("B5", "tiny[5,13,512]", 5, 13), ("B5'", "tiny[5,3,512]", 5, 3)]
    for name, tag, m, s in pick(b5_rows):
        q, k, v = (rnd(m, s, 512).to(bf) for _ in range(3))
        if name != "B5'":
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
        if tag in ("slice[5400,13,512]", "slice[5400,25,512]"):
            # no sums across items, so a second call repeats the first bit for bit
            check_ok(name, f"{tag} run twice: bitwise equal", torch.equal(got, kern()))
    # B5 and B5' past 16 rows (the long body), untimed: M = 1,001 (a
    # persistent warp's last items ragged) at S = 17 (one row into a second
    # tile), 24, 25, 31, 32, 33 (a third tile), 48, 64, 129 (nine tiles) and
    # pa.MAX_S[64] (the most shared memory a warp takes); B5' at 17 and 25
    # through `packed_head_attention`'s [M, S*8, 64] view.
    # tol: as the timed rows.
    long_s = LONG_S + (pa.MAX_S[64],)
    for name, s in pick([("B5", s) for s in long_s] + [("B5'", 17), ("B5'", 25)]):
        q, k, v = (rnd(1001, s, 512).to(bf) for _ in range(3))
        if name == "B5":
            got = pa.tiny_seq_attention(q, k, v, 8, 0.125)
            want = pa.tiny_seq_attention_plain(q, k, v, 8, 0.125)
        else:
            packed = [t.reshape(1001, s * 8, 64) for t in (q, k, v)]
            got = pa.packed_head_attention(*packed, 8, 0.125).reshape(1001, s, 512)
            want = pa.packed_head_attention_plain(*packed, 8, 0.125).reshape(1001, s, 512)
        check(name, f"ragged[1001,{s},512]", got, want, 1e-2, 2e-2)

    # --- B6: audio norm_q rows [2*17550, 3072], AudioProjModel [2*2*13*32, 768];
    # the face path's widths: router norms [35100, 2048], STAB/trunk [70200, 512]
    # tol: one bf16 rounding of the same fp32 value, summed in another order
    # library: F.layer_norm (affine cast to bf16 before timing)
    # the 2B variant's audio norm_q rows [2*17550, 1920]
    for tag, rows, d in pick((("slice[35100,3072]", 35100, 3072), ("slice[1664,768]", 1664, 768),
                              ("slice[35100,2048]", 35100, 2048), ("slice[70200,512]", 70200, 512),
                              ("ragged[1001,768]", 1001, 768), ("2b[35100,1920]", 35100, 1920)),
                             ["B6"]):
        x = rnd(rows, d, std=2.3, mean=0.7).to(bf)
        sc, bi = rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1)
        scb, bib = sc.to(bf), bi.to(bf)
        kern = lambda: ln.fused_layernorm(x, sc, bi)
        plain = lambda: ln.layernorm_plain(x, sc, bi)
        library = lambda: F.layer_norm(x, (d,), scb, bib, 1e-5)
        work = (_nbytes(x, sc, bi, x), 8.0 * rows * d, "fp32")
        r = report("B6", tag, kern(), plain(), 1e-2, 1e-2, kern, plain, 20, library, work)
        if tag in ("slice[35100,3072]", "2b[35100,1920]"):
            results["B6" if tag.startswith("slice") else "B6 2b"] = r
    # B6 hazards, not timed: a ragged row count (1,001) at every width above,
    # at the wrapper's extremes (D = 128, 8192) and at widths whose 16-byte
    # chunks do not fill the threads of a row (640, 1152)
    for d in pick((128, 512, 640, 768, 1152, 1920, 2048, 3072, 8192), ["B6"]):
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
        flat = q_q.reshape(g, sq, h * d)
        cases = [("B14", "combined", skv.short_kv_attention_combined_qmajor, (q_q, k, v, w)),
                 ("B2c", "head-major combined", skv.short_kv_attention_combined,
                  (q_h, k, v, w)),
                 ("B3", "flat combined", skv.short_kv_attention_combined_flat, (flat, k, v, w))]
        if not combined_only:
            cases += [("B14", "per-id", skv.short_kv_attention_qmajor, (q_q, k, v)),
                      ("B2h", "head-major per-id", skv.short_kv_attention, (q_h, k, v)),
                      ("B2", "flat per-id", skv.short_kv_attention_flat, (flat, k, v))]
        return pick(cases)

    # every body at Sq = 1,000 over 3 batches: 48 heads at D <= 64 (8 blocks
    # a head, shares of 6 tiles), 16 at 128, 8 at 256 (16 blocks a head at
    # one block an SM: shares of 3 tiles, one of them 15..17); and the
    # combined calls at [26, 1350] (shares of tens of tiles) as 16 x 128,
    # 192 x 16 and 12 x 256 heads
    heads_of = lambda d: 48 if d <= 64 else 16 if d <= 128 else 8
    hazards = [(3, 1000, heads_of(d), d, n_id, False)
               for d in (16, 32, 48, 64, 128, 256) for n_id in (1, 2, 4)]
    hazards += [(26, 1350, 16, 128, 2, True), (26, 1350, 192, 16, 2, True),
                (26, 1350, 12, 256, 2, True)]
    for g, sq, h, d, n_id, combined_only in hazards:
        for name, what, fn, args in skv_cases(g, sq, h, d, n_id, combined_only):
            plain = getattr(skv, f"{fn.__name__}_plain")
            check(name, f"ragged {what} [G={g},Sq={sq},H={h},D={d}] I={n_id}",
                  fn(*args, d ** -0.5), plain(*args, d ** -0.5), 1e-2, 2e-2)
    # report() and report_all() clear ok_all themselves
    train_kernel_phase(results, rnd, report, report_all, bhsd, pick, check, check_ok)
    layout_kernel_phase(results, rnd, report, report_all, pick)
    head_dim_kernel_phase(results, rnd, report, report_all, bhsd, pick, check)
    width_kernel_phase(results, rnd, report, report_all, check, check_ok, bhsd, only)
    token_kernel_phase(results, rnd, report, check, bhsd, only)
    stream_kernel_phase(results, rnd, report, report_all, check, check_ok, bhsd, only)
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

    # --- B7 at the other flat head dims: the DiT blocks' q/k/v [1, 17776,
    # 3072] as 96 x 32 and 24 x 128 heads with RoPE on rows 226..17775, and
    # ragged [1, 1000, 3072] with a masked kv tail (937), RoPE from row 10.
    # tol: as the dh-64 rows.  No library call applies RoPE; `sdpa_bare_ms`
    # times SDPA on the same q/k/v without it (forward; forward + autograd
    # backward as the backward), a yardstick of the attention alone.
    for d, (tag, b, s, text_len, grid, kv_len) in pick(
            [(d, row) for d in (32, 128) for row in (
                (f"train[1,17776,3072] rope dh{d}", 1, 17776, 226, (13, 30, 45), None),
                (f"ragged[1,1000,3072] kv_len=937 rope dh{d}", 1, 1000, 10, (3, 18, 18),
                 937))], ["B7 fwd", "B7 bwd"]):
        h = 3072 // d
        q, k, v, do = (rnd(b, s, 3072).to(bf) for _ in range(4))
        kw = dict(kv_len=kv_len, rope_start=text_len,
                  rope=get_3d_rotary_pos_embed(d, ((0, 0), grid[1:]), grid[1:], grid[0],
                                               device=dev))
        kv = kv_len or s
        fwd = lambda: fa.flash_attention_flat_fwd(q, k, v, h, **kw)
        fwd_plain = lambda: fa.flash_attention_flat_fwd_plain(q, k, v, h, block_q=512, **kw)
        o, lse = fwd()
        o_p, lse_p = fwd_plain()
        work = (_nbytes(q, k, v, o, lse), 4.0 * b * s * kv * 3072, "bf16")
        r = report_all(f"B7 fwd dh{d}", tag, (o, lse), (o_p, lse_p), (2e-2, 3e-3), fwd,
                       fwd_plain, 3, None, work)
        delta = fa.attention_delta(o, do, h)
        bwd = lambda: fa.flash_attention_flat_bwd(q, k, v, do, lse, delta, h, **kw)
        bwd_plain = lambda: fa.flash_attention_flat_bwd_plain(q, k, v, do, lse, delta, h,
                                                              block_q=512, **kw)
        work = (_nbytes(q, k, v, do, lse, delta, q, k, v), 10.0 * b * s * kv * 3072, "bf16")
        r_b = report_all(f"B7 bwd dh{d}", tag, bwd(), bwd_plain(), (2e-2, 2e-2, 2e-2), bwd,
                         bwd_plain, 3, None, work)
        if tag.startswith("train"):
            qb, kb, vb = (bhsd(t, h).requires_grad_() for t in (q, k, v))
            ob = F.scaled_dot_product_attention(qb, kb, vb)
            dob = bhsd(do, h)
            r["sdpa_bare_ms"] = _time_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb), 3)
            r_b["sdpa_bare_ms"] = _time_ms(
                lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True), 3)
            print(f"kernel B7 dh{d} {tag}: SDPA on the same q/k/v without RoPE: forward "
                  f"{r['sdpa_bare_ms']:.4f} ms, backward {r_b['sdpa_bare_ms']:.4f} ms",
                  flush=True)
            results[f"B7 fwd dh{d}"], results[f"B7 bwd dh{d}"] = r, r_b
            del qb, kb, vb, ob, dob
        del q, k, v, do, o, lse, o_p, lse_p, delta

    # --- B8: temporal STAB attention backward [2700, 13, 8*64] (batch 1:
    # M = 2 identities x 30 x 45); ragged M = 1001.
    # tol: both sides compute the softmax vjp in fp32 from the same bf16
    # inputs and round once: 1e-2 of each gradient's largest magnitude.
    # library: SDPA at S = 13 on [M, 8, 13, 64] copies, its autograd
    # backward timed alone.
    # At 81 and 97 frames [2700, 21, 512] and [2700, 25, 512] on the long
    # body (rows "B8 S21", "B8 S25").
    for name, tag, m, s in pick((("B8", "train[2700,13,512]", 2700, 13),
                                 ("B8", "ragged[1001,13,512]", 1001, 13),
                                 ("B8 S21", "train[2700,21,512]", 2700, 21),
                                 ("B8 S25", "train[2700,25,512]", 2700, 25)), ["B8"]):
        q, k, v, g = (rnd(m, s, 512).to(bf) for _ in range(4))
        qh, kh, vh = (bhsd(t, 8).requires_grad_() for t in (q, k, v))
        oh = F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)
        gh = bhsd(g, 8)
        lib = lambda: torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True)
        kern = lambda: pa.tiny_seq_attention_bwd(q, k, v, g, 8, 0.125)
        plain = lambda: pa.tiny_seq_attention_bwd_plain(q, k, v, g, 8, 0.125)
        work = (_nbytes(q, k, v, g, q, k, v), 10.0 * m * 8 * s * s * 64, "fp32")
        r = report_all(name, tag, kern(), plain(), (1e-2,) * 3, kern, plain, 20, lib, work)
        if tag.startswith("train"):
            results[name] = r

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
    # tile) and on the long body at B5's lengths past 16 (pad rows 15, 8, 7,
    # 1, 0, 15, 0, 0, 15 and 0 of the last tile).  B9: 1,001 rows at every
    # width (D = 640 and 1,152 leave a thread's last chunk empty, 8,192
    # takes four chunks a thread), and fewer rows than the card holds blocks
    # ([64, 2048], [5, 3072]: a grid of row steps, no block without rows).
    # tol: as the timed rows.
    def check_twice(name, tag, fn, want, rels):
        first, again = fn(), fn()
        for i, (got, ref, rel) in enumerate(zip(first, want, rels)):
            check(name, f"{tag} out{i}", got, ref, _rel_compare(got, ref, rel), rel)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        check_ok(name, f"{tag} run twice: bitwise equal", same)

    for s_ in pick((8, 13, 16) + LONG_S + (pa.MAX_S[64],), ["B8"]):
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


# the phase-2 names of the head-dim classes (`--only-kernels dh16`): each
# runs every kernel's rows at that head dim (dh32, dh64 and dh128: B10's);
# `dsweep` the sweep of D
HEAD_DIM_CLASSES = ("dh16", "dh32", "dh48", "dh64", "dh96", "dh128", "dh256", "dsweep",
                    "widths", "tokens", "stream")


def _rope_tables(rows: int, d: int, gen, dev):
    """Rotate-half RoPE tables [rows, d] of drawn angles (both halves alike,
    as the 3D tables are), for head dims the 3D split does not take."""
    import torch

    phi = torch.rand((rows, d // 2), generator=gen, device=dev) * 3.0
    ang = torch.cat([phi, phi], dim=1)
    return ang.cos(), ang.sin()


def head_dim_kernel_phase(results: dict, rnd, report, report_all, bhsd, pick, check) -> None:
    """The flash kernels and B10 at the head dims they took last, against
    their plain versions: every new class at the 5B joint sequence, the
    bare STAB shape at 2 x 256 heads, and every D % 8 == 0 from 8 to 256 at
    a small ragged shape (the instantiation check)."""
    import torch
    import torch.nn.functional as F
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import layernorm as ln
    from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(4321)
    s_full, text_len, grid = 17776, 226, (13, 30, 45)

    def sdpa_bare(q, k, v, do, layout):
        """SDPA's forward and backward (forward + autograd backward timed as
        the backward) on the same q/k/v without RoPE, in its bhsd layout:
        a yardstick of the attention alone."""
        qb, kb, vb = ((t if layout == "bhsd" else t.transpose(1, 2)).contiguous()
                      .requires_grad_() for t in (q, k, v))
        dob = (do if layout == "bhsd" else do.transpose(1, 2)).contiguous()
        ob = F.scaled_dot_product_attention(qb, kb, vb)
        f = _time_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb), 3)
        b = _time_ms(lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True), 3)
        return f, b

    def timed(fn):
        """(fn(), its one call's ms): the plain versions at full length take
        seconds, so the call that makes a reference is the one timed."""
        out = []
        return out, _time_ms(lambda: out.append(fn()), 1, warmup=0)

    # --- B11 and B12 + B13 at D = 16, 48, 96 and 256: the 5B joint sequence
    # [1, 17776, 3072] as 192, 64, 32 and 12 heads, bshd and bhsd (the same
    # values transposed, so the bshd call's plain outputs, transposed, are
    # the bhsd rows' references and its plain time theirs), RoPE on rows
    # 226..17775.  D = 16 and 48 run the 64-column bodies, 96 the 128 one,
    # 256 the 256-column bodies (two CTAs a q or kv tile, each owning 128 of
    # the output columns).  The bshd D = 16 rows are the kernels line's
    # (phase 3f's 189 x 16 DiT takes them).
    # tol: as the dh-64 rows (phase 2's B11 / B12 + B13).  No library call
    # applies RoPE; SDPA without it is printed beside (`sdpa_bare_ms`).
    for cls, d in pick([(f"dh{d}", d) for d in (16, 48, 96, 256)]):
        h = 3072 // d
        rope = get_3d_rotary_pos_embed(d, ((0, 0), grid[1:]), grid[1:], grid[0], device=dev)
        q, k, v, do = (rnd(1, s_full, h, d).to(bf) for _ in range(4))
        lib = sdpa_bare(q, k, v, do, "bshd")
        want_f = want_b = None
        for layout in ("bshd", "bhsd"):
            if layout == "bhsd":
                q, k, v, do = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
            kw = dict(layout=layout, rope=rope, rope_start=text_len)
            tag = f"{layout}[{','.join(map(str, q.shape))}] RoPE dh{d}"
            fwd = lambda: fa.flash_attention_fwd(q, k, v, **kw)
            fwd_plain = lambda: fa.flash_attention_fwd_plain(q, k, v, block_q=256, **kw)
            o, lse = fwd()
            if want_f is None:
                (want_f,), ms_f = timed(fwd_plain)
            else:       # the bshd references in bhsd
                want_f = (want_f[0].transpose(1, 2), want_f[1])
            work = (_nbytes(q, k, v, o, lse), 4.0 * s_full * s_full * 3072, "bf16")
            r = report_all(f"B11 dh{d}", tag, (o, lse), want_f, (2e-2, 3e-3), fwd, fwd_plain, 3,
                           None, work, ms_f)
            bwd = lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            bwd_plain = lambda: fa.flash_attention_bwd_plain(q, k, v, o, do, lse, block_q=256,
                                                             **kw)
            if want_b is None:
                (want_b,), ms_b = timed(bwd_plain)
            else:
                want_b = tuple(g.transpose(1, 2) for g in want_b)
            work = (_nbytes(q, k, v, o, do, lse, q, k, v), 10.0 * s_full * s_full * 3072, "bf16")
            r_b = report_all(f"B12+B13 dh{d}", tag, bwd(), want_b, (2e-2, 2e-2, 2e-2), bwd,
                             bwd_plain, 3, None, work, ms_b)
            r["sdpa_bare_ms"], r_b["sdpa_bare_ms"] = lib
            print(f"kernel B11 / B12+B13 dh{d} {tag}: SDPA on the same q/k/v without RoPE: "
                  f"forward {lib[0]:.4f} ms, backward {lib[1]:.4f} ms", flush=True)
            if layout == "bshd" and d == 16:
                results["B11 dh16"], results["B12+B13 dh16"] = r, r_b
            del o, lse
        del q, k, v, do, want_f, want_b

    # --- B7 (flat, forward and backward) at 192 x 16 and 12 x 256 heads on
    # the DiT blocks' [1, 17776, 3072] with RoPE (phase 3f's flat DiTs);
    # B1 (bare, inference) and B7 at the STAB spatial shape [52, 1350, 512]
    # as 2 x 256 heads, where SDPA computes the same function.
    # tol: as the dh-64 rows.
    for cls, d, h in pick([("dh16", 16, 192), ("dh256", 256, 12)]):
        rope = get_3d_rotary_pos_embed(d, ((0, 0), grid[1:]), grid[1:], grid[0], device=dev)
        q, k, v, do = (rnd(1, s_full, 3072).to(bf) for _ in range(4))
        kw = dict(rope=rope, rope_start=text_len)
        tag = f"train[1,17776,3072] {h}x{d} rope"
        fwd = lambda: fa.flash_attention_flat_fwd(q, k, v, h, **kw)
        fwd_plain = lambda: fa.flash_attention_flat_fwd_plain(q, k, v, h, block_q=256, **kw)
        o, lse = fwd()
        (want,), ms = timed(fwd_plain)
        work = (_nbytes(q, k, v, o, lse), 4.0 * s_full * s_full * 3072, "bf16")
        r = report_all(f"B7 fwd dh{d}", tag, (o, lse), want, (2e-2, 3e-3), fwd, fwd_plain, 3,
                       None, work, ms)
        del want
        delta = fa.attention_delta(o, do, h)
        bwd = lambda: fa.flash_attention_flat_bwd(q, k, v, do, lse, delta, h, **kw)
        bwd_plain = lambda: fa.flash_attention_flat_bwd_plain(q, k, v, do, lse, delta, h,
                                                              block_q=256, **kw)
        (want,), ms = timed(bwd_plain)
        work = (_nbytes(q, k, v, do, lse, delta, q, k, v), 10.0 * s_full * s_full * 3072, "bf16")
        r_b = report_all(f"B7 bwd dh{d}", tag, bwd(), want, (2e-2, 2e-2, 2e-2), bwd, bwd_plain,
                         3, None, work, ms)
        del want
        split = lambda t: t.reshape(1, s_full, h, d)
        r["sdpa_bare_ms"], r_b["sdpa_bare_ms"] = sdpa_bare(*map(split, (q, k, v, do)), "bshd")
        print(f"kernel B7 dh{d} {tag}: SDPA on the same q/k/v without RoPE: forward "
              f"{r['sdpa_bare_ms']:.4f} ms, backward {r_b['sdpa_bare_ms']:.4f} ms", flush=True)
        results[f"B7 fwd dh{d}"], results[f"B7 bwd dh{d}"] = r, r_b
        del q, k, v, do, o, lse, delta
    # --- B1 with the QK-LN and RoPE fused at 12 x 256 heads on the 5B joint
    # sequence [2, 17776, 3072], and ragged (1,000 rows, kv_len 937): the
    # 256-column body behind the pre-pass (the DiT at 12 x 256 takes B10
    # and B7's forward or B11 instead, so no phase launches it).
    # tol: as the dh-64 rows.  No library call applies the QK-LN and RoPE.
    for cls, tag, b, s, text_len, grid, kv_len in pick([
            ("dh256", "slice[2,17776,3072] 12x256 LN+RoPE", 2, 17776, 226, (13, 30, 45), None),
            ("dh256", "ragged[1,1000,3072] kv_len=937 12x256 LN+RoPE", 1, 1000, 10, (3, 18, 18),
             937)]):
        d, h = 256, 12
        q, k, v = (rnd(b, s, 3072).to(bf) for _ in range(3))
        norm = (rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1), rnd(d, std=0.1, mean=1.0),
                rnd(d, std=0.1))
        kw = dict(kv_len=kv_len, qk_norm=norm, rope_start=text_len,
                  rope=get_3d_rotary_pos_embed(d, ((0, 0), grid[1:]), grid[1:], grid[0],
                                               device=dev))
        kern = lambda: fa.flash_attention(q, k, v, h, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, h, block_q=512, **kw)
        work = (_nbytes(q, k, v, q), 4.0 * b * s * (kv_len or s) * 3072, "bf16")
        report("B1 dh256", tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 3, None, work)
        del q, k, v
    if pick([("dh256",)]):
        b, s, h, d = 52, 1350, 2, 256
        q, k, v, do = (rnd(b, s, h * d).to(bf) for _ in range(4))
        qb, kb, vb = (bhsd(t, h) for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(qb, kb, vb)
        kern = lambda: fa.flash_attention(q, k, v, h)
        plain = lambda: fa.flash_attention_plain(q, k, v, h, block_q=512)
        work = (_nbytes(q, k, v, q), 4.0 * b * h * s * s * d, "bf16")
        report("B1 dh256", "bare[52,1350,512] 2x256", kern(), plain(), 1e-2, 2e-2, kern, plain,
               5, lib, work)
        fwd = lambda: fa.flash_attention_flat_fwd(q, k, v, h)
        fwd_plain = lambda: fa.flash_attention_flat_fwd_plain(q, k, v, h, block_q=512)
        o, lse = fwd()
        report_all("B7 fwd dh256", "bare[52,1350,512] 2x256", (o, lse), fwd_plain(),
                   (2e-2, 3e-3), fwd, fwd_plain, 3, lib, (_nbytes(q, k, v, o, lse),
                                                         4.0 * b * h * s * s * d, "bf16"))
        qg, kg, vg = (t.detach().requires_grad_() for t in (qb, kb, vb))
        og = F.scaled_dot_product_attention(qg, kg, vg)
        dob = bhsd(do, h)
        delta = fa.attention_delta(o, do, h)
        bwd = lambda: fa.flash_attention_flat_bwd(q, k, v, do, lse, delta, h)
        bwd_plain = lambda: fa.flash_attention_flat_bwd_plain(q, k, v, do, lse, delta, h,
                                                              block_q=512)
        report_all("B7 bwd dh256", "bare[52,1350,512] 2x256", bwd(), bwd_plain(),
                   (2e-2, 2e-2, 2e-2), bwd, bwd_plain, 3,
                   lambda: torch.autograd.grad(og, (qg, kg, vg), dob, retain_graph=True),
                   (_nbytes(q, k, v, do, lse, delta, q, k, v), 10.0 * b * h * s * s * d, "bf16"))
        del q, k, v, do, o, lse, qb, kb, vb, qg, kg, vg, og, dob, delta

    # --- B10 at segments of 16 (192 heads, past the JAX kernel's 128), 32,
    # 48 (not a power of two: a [64, 64] block, 16 columns masked), 96, 128
    # and 256 on the QK norms' [17776, 3072], forward and backward, timed;
    # and phase 3f's widths, 189 x 16 (3,024) and 47 x 64 (3,008: 47 heads
    # in a 64-row block), checked.  The dh-16 and dh-256 rows are the
    # kernels line's.
    # tol: as the dh-64 rows.  library: F.layer_norm on the [M, H, dh] view
    # (forward; its autograd backward timed alone).
    for cls, seg, c in pick([(f"dh{seg}", seg, 3072) for seg in (16, 32, 48, 96, 128, 256)]
                            + [("dh16", 16, 3024), ("dh64", 64, 3008)]):
        rows = 17776
        x = rnd(rows, c, std=2.3, mean=0.7).to(bf)
        g = rnd(rows, c).to(bf)
        sc, bi = rnd(seg, std=0.1, mean=1.0), rnd(seg, std=0.1)
        tag = f"train[{rows},{c}] dh{seg}"
        fk = lambda: ln.head_layernorm_fwd(x, sc, bi, 1e-6)
        fp = lambda: ln.head_layernorm_plain(x, sc, bi, 1e-6)
        kern = lambda: ln.head_layernorm_bwd(x, sc, g, 1e-6)
        plain = lambda: ln.head_layernorm_bwd_plain(x, sc, g, 1e-6)
        if c != 3072:
            check("B10 fwd", tag, fk(), fp(), 1e-2, 1e-2)
            for i, (got, ref, rel) in enumerate(zip(kern(), plain(), (1e-2, 1e-3, 1e-3))):
                check("B10 bwd", f"{tag} out{i}", got, ref, _rel_compare(got, ref, rel), rel)
            continue
        view = lambda t: t.reshape(rows, c // seg, seg)
        xl = view(x).detach().requires_grad_()
        scl, bil = sc.to(bf).requires_grad_(), bi.to(bf).requires_grad_()
        yl = F.layer_norm(xl, (seg,), scl, bil, 1e-6)
        lib_f = lambda: F.layer_norm(view(x), (seg,), sc.to(bf), bi.to(bf), 1e-6)
        lib_b = lambda: torch.autograd.grad(yl, (xl, scl, bil), view(g), retain_graph=True)
        r = report(f"B10 fwd dh{seg}", tag, fk(), fp(), 1e-2, 1e-2, fk, fp, 20, lib_f,
                   (_nbytes(x, sc, bi, x), 8.0 * rows * c, "fp32"))
        r_b = report_all(f"B10 bwd dh{seg}", tag, kern(), plain(), (1e-2, 1e-3, 1e-3), kern,
                         plain, 20, lib_b, (_nbytes(x, sc, g, x, sc, bi), 12.0 * rows * c,
                                            "fp32"))
        if seg in (16, 256):
            results[f"B10 fwd dh{seg}"], results[f"B10 bwd dh{seg}"] = r, r_b
        del x, g, xl, yl

    # --- every D % 8 == 0 from 8 to 256 at a small ragged shape: S = 1,100
    # (not a multiple of the 128-row tile) with kv_len 1,000 (a part-masked
    # kv tile, and kv tiles wholly past it: dk = dv = 0), 3 heads (an odd
    # count: each bshd row is followed by the next head's columns, which a
    # tile wider than D must not read).  bshd with RoPE from row 10 (drawn
    # angles: the any-width pre-pass, its partner i +- D/2, dk rotated by
    # the post-pass), forward also with the QK-LN; bhsd bare (dk stored by
    # the kernel).  Flat (B1 with QK-LN and RoPE, B7 forward and backward
    # with RoPE) at the dims whose heads pack: 8, 16, 32, 64, 128 and 256
    # heads 2 hpb wide.  Checked, not timed.  tol: as the timed rows.
    if pick([("dsweep",)]):
        s, kv_len, t0 = 1100, 1000, 10
        for d in range(8, 257, 8):
            rope = _rope_tables(s - t0 - 50, d, gen, dev)
            norm = (rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1), rnd(d, std=0.1, mean=1.0),
                    rnd(d, std=0.1))
            for layout in ("bshd", "bhsd"):
                shape = (1, s, 3, d) if layout == "bshd" else (1, 3, s, d)
                q, k, v, do = (rnd(*shape).to(bf) for _ in range(4))
                kw = dict(layout=layout, kv_len=kv_len)
                if layout == "bshd":
                    kw.update(rope=rope, rope_start=t0)
                    check("B11", f"sweep {layout}{list(shape)} kv_len={kv_len} LN+RoPE",
                          fa.flash_attention_fwd(q, k, v, qk_norm=norm, **kw)[0],
                          fa.flash_attention_fwd_plain(q, k, v, qk_norm=norm, **kw)[0],
                          2e-2, 2e-2)
                what = "RoPE" if layout == "bshd" else "bare"
                o, lse = fa.flash_attention_fwd(q, k, v, **kw)
                o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
                for i, (got, ref, rel) in enumerate(((o, o_p, 2e-2), (lse, lse_p, 3e-3))):
                    check("B11", f"sweep {layout}{list(shape)} kv_len={kv_len} {what} out{i}",
                          got, ref, _rel_compare(got, ref, rel), rel)
                got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
                want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
                for i, (g_, w_) in enumerate(zip(got, want)):
                    check("B12+B13", f"sweep {layout}{list(shape)} kv_len={kv_len} {what} "
                          f"out{i}", g_, w_, _rel_compare(g_, w_, 2e-2), 2e-2)
        for d in (8, 16, 32, 64, 128, 256):
            h = 2 * max(1, 128 // d)
            rope = _rope_tables(s - t0 - 50, d, gen, dev)
            norm = (rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1), rnd(d, std=0.1, mean=1.0),
                    rnd(d, std=0.1))
            q, k, v, do = (rnd(1, s, h * d).to(bf) for _ in range(4))
            kw = dict(kv_len=kv_len, rope=rope, rope_start=t0)
            tag = f"sweep flat[1,{s},{h}x{d}] kv_len={kv_len}"
            check("B1", f"{tag} LN+RoPE", fa.flash_attention(q, k, v, h, qk_norm=norm, **kw),
                  fa.flash_attention_plain(q, k, v, h, qk_norm=norm, **kw), 1e-2, 2e-2)
            o, lse = fa.flash_attention_flat_fwd(q, k, v, h, **kw)
            o_p, lse_p = fa.flash_attention_flat_fwd_plain(q, k, v, h, **kw)
            for i, (got, ref, rel) in enumerate(((o, o_p, 2e-2), (lse, lse_p, 3e-3))):
                check("B7 fwd", f"{tag} RoPE out{i}", got, ref, _rel_compare(got, ref, rel), rel)
            delta = fa.attention_delta(o, do, h)
            got = fa.flash_attention_flat_bwd(q, k, v, do, lse, delta, h, **kw)
            want = fa.flash_attention_flat_bwd_plain(q, k, v, do, lse, delta, h, **kw)
            for i, (g_, w_) in enumerate(zip(got, want)):
                check("B7 bwd", f"{tag} RoPE out{i}", g_, w_, _rel_compare(g_, w_, 2e-2), 2e-2)


# the head widths the short-KV and packed kernels took last: the dh classes
# of `--only-kernels` pick their rows by width, `widths` all of them
WIDTH_CLASS = "widths"
# their kernels line rows: (name, the wrapper's name in `_kernel_fns`)
WIDTH_ROWS = (*((f"B3 dh{d}", "B3") for d in (16, 32, 128, 256)),
              *((f"{n} dh{d}", n) for n in ("B2", "B14", "B2c", "B2h") for d in (48, 256)),
              *((f"{n} dh{d}", n) for n in ("B5", "B5'", "B8") for d in (32, 48, 128)),
              ("B4 dh32", "B4"), ("B4 dh128", "B4"), ("B4 C384", "B4"))


def width_kernel_phase(results: dict, rnd, report, report_all, check, check_ok, bhsd,
                       only) -> None:
    """The short-KV and packed kernels at the head widths they took last,
    against their plain versions: each new instantiation timed at its
    path's shape (the rows of `WIDTH_ROWS`), then checked, untimed, at its
    hazards (ragged M, S at each width's long-body cap, B8 run twice)."""
    import torch
    import torch.nn.functional as F
    from bindyouravatar_tpu_torch.ops import packed_attention as pa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(2468)
    firsts = None if only is None else {o.split()[0] for o in only}

    def pick(rows):
        """The rows (name, dh, ...) asked for by their kernel's first word,
        their dh class or `widths`."""
        return [r for r in rows if firsts is None or r[0].split()[0] in firsts
                or f"dh{r[1]}" in firsts or WIDTH_CLASS in firsts]

    # --- B3 at the DiT's other head splits, q [26, 1350, 3072] as 192 x 16,
    # 96 x 32, 24 x 128 and 12 x 256 heads (the audio layers that
    # `DiT.create` derives for those DiTs: phase 3g), routing weights
    # ~U(0, 1).  16 and 32 ride the 64-column body (the boxes read columns
    # D..63 as zeros), 128 the 128 one, 256 its own.
    # tol: as B3's row.  library: none (no single call weights the
    # identities' softmaxes).
    for name, d in pick([(f"B3 dh{d}", d) for d in (16, 32, 128, 256)]):
        h = 3072 // d
        q = rnd(26, 1350, 3072).to(bf)
        k, v = (rnd(26, 2, h, 32, d).to(bf) for _ in range(2))
        w = torch.rand((26, 1350, 2), generator=gen, device=dev).to(bf)
        kern = lambda: skv.short_kv_attention_combined_flat(q, k, v, w, d ** -0.5)
        plain = lambda: skv.short_kv_attention_combined_flat_plain(q, k, v, w, d ** -0.5)
        work = (_nbytes(q, k, v, w, q), 4.0 * 26 * 2 * 1350 * 32 * 3072, "bf16")
        results[name] = report(name, f"slice[26,1350,3072] {h}x{d} I=2 w~U(0,1)", kern(),
                               plain(), 1e-2, 2e-2, kern, plain, 20, None, work)

    # --- B2, B14, B2c and B2h at D = 48 (the 64 body, 16 columns read as
    # zeros) and 256 (its own body): B2 on the perceiver's flat q [2, 17550,
    # H*D] (16 x 48, 8 x 256), B14 combined on the audio geometry q-major
    # [26, 1350, 3072 / D, D], B2c the same head-major, B2h per identity
    # head-major [2, H, 17550, D].
    # tol: as the D = 64 / 128 rows.  library: SDPA with the identities
    # folded into the heads for the per-identity calls (q repeated before
    # timing); none for the combined ones.
    for name, d in pick([(f"{n} dh{d}", d) for n in ("B2", "B14", "B2c", "B2h")
                         for d in (48, 256)]):
        kind = name.split()[0]
        combine = kind in ("B14", "B2c")
        g, sq, h = (26, 1350, 3072 // d) if combine else (2, 17550, 768 // d if d == 48 else 8)
        k, v = (rnd(g, 2, h, 32, d).to(bf) for _ in range(2))
        w = torch.rand((g, sq, 2), generator=gen, device=dev).to(bf)
        if kind == "B2":
            q = rnd(g, sq, h * d).to(bf)
            fn, args, tag = skv.short_kv_attention_flat, (q, k, v), f"flat[2,17550,{h * d}]"
            qh = bhsd(q, h)
        elif kind == "B14":
            q = rnd(g, sq, h, d).to(bf)
            fn, args = skv.short_kv_attention_combined_qmajor, (q, k, v, w)
            tag = f"combined[26,1350,{h},{d}]"
        elif kind == "B2c":
            q = rnd(g, h, sq, d).to(bf)
            fn, args = skv.short_kv_attention_combined, (q, k, v, w)
            tag = f"head-major combined[26,{h},1350,{d}]"
        else:
            q = rnd(g, h, sq, d).to(bf)
            fn, args, tag = skv.short_kv_attention, (q, k, v), f"head-major per-id[2,{h},17550,{d}]"
            qh = q
        plain_fn = getattr(skv, f"{fn.__name__}_plain")
        kern = lambda: fn(*args, d ** -0.5)
        plain = lambda: plain_fn(*args, d ** -0.5)
        library = None
        if not combine:
            qi = qh.unsqueeze(1).expand(g, 2, h, sq, d).reshape(g, 2 * h, sq, d).contiguous()
            ki, vi = k.reshape(g, 2 * h, 32, d), v.reshape(g, 2 * h, 32, d)
            library = lambda: F.scaled_dot_product_attention(qi, ki, vi)
        work = (_nbytes(*args) + _nbytes(q) * (1 if combine else 2),
                4.0 * g * 2 * h * sq * 32 * d, "bf16")
        results[name] = report(name, f"{tag} I=2 K=32", kern(), plain(), 1e-2, 2e-2, kern,
                               plain, 20, library, work)

    # --- B5, B5' and B8 at the temporal STAB's other head splits: 16 x 32
    # and 4 x 128 heads over its 512 channels (`RouterConfig.attn_heads` 16
    # and 4: phase 3g) and 8 x 48 (384 channels, no model of the smoke:
    # phase 3h), at [5400, 13, C] (49 frames; B8 at [2700, 13, C], batch 1),
    # B5' at S = 3 on the packed [5400, 3 H, dh] view.  32 and 48 ride the
    # 64-column bodies, 128 the 128 ones.
    # tol: as the dh-64 rows.  library: SDPA on [M, H, S, dh] copies
    # (permuted before timing); B8: its autograd backward timed alone.
    for name, d in pick([(f"{n} dh{d}", d) for n in ("B5", "B5'", "B8") for d in (32, 48, 128)]):
        kind = name.split()[0]
        h = 8 if d == 48 else 512 // d
        c = h * d
        m, s_ = (2700, 13) if kind == "B8" else (5400, 3 if kind == "B5'" else 13)
        q, k, v, g = (rnd(m, s_, c).to(bf) for _ in range(4))
        sc = d ** -0.5
        tag = f"[{m},{s_},{c}] {h}x{d}"
        if kind == "B8":
            qh, kh, vh = (bhsd(t, h).requires_grad_() for t in (q, k, v))
            oh = F.scaled_dot_product_attention(qh, kh, vh, scale=sc)
            gh = bhsd(g, h)
            lib = lambda: torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True)
            kern = lambda: pa.tiny_seq_attention_bwd(q, k, v, g, h, sc)
            plain = lambda: pa.tiny_seq_attention_bwd_plain(q, k, v, g, h, sc)
            work = (_nbytes(q, k, v, g, q, k, v), 10.0 * m * h * s_ * s_ * d, "fp32")
            results[name] = report_all(name, f"train{tag}", kern(), plain(), (1e-2,) * 3, kern,
                                       plain, 20, lib, work)
            continue
        if kind == "B5":
            kern = lambda: pa.tiny_seq_attention(q, k, v, h, sc)
            plain = lambda: pa.tiny_seq_attention_plain(q, k, v, h, sc)
        else:
            packed = [t.reshape(m, s_ * h, d) for t in (q, k, v)]
            kern = lambda: pa.packed_head_attention(*packed, h, sc)
            plain = lambda: pa.packed_head_attention_plain(*packed, h, sc)
        qh, kh, vh = bhsd(q, h), bhsd(k, h), bhsd(v, h)
        library = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=sc)
        work = (_nbytes(q, k, v, q), 4.0 * m * h * s_ * s_ * d, "bf16")
        results[name] = report(name, f"slice{tag}", kern().reshape(m, s_, c),
                               plain().reshape(m, s_, c), 1e-2, 2e-2, kern, plain, 20, library,
                               work)

    # --- B4 at the multi-ID STAB's other head splits, [2, 2, 17550, C]: 16 x
    # 32 and 4 x 128 heads over 512 channels (phase 3g), and C = 384 (8 x
    # 48: the head width padded to 64 lanes in the Triton block, masked).
    # tol: as B4's row.  library: SDPA over the pair axis on a [B*M, H, 2,
    # dh] copy (permuted before timing).
    for name, d, h in pick([("B4 dh32", 32, 16), ("B4 dh128", 128, 4), ("B4 C384", 48, 8)]):
        c = h * d
        q, k, v = (rnd(2, 2, 17550, c).to(bf) for _ in range(3))
        kern = lambda: pa.pair_axis_attention(q, k, v, h, d ** -0.5)
        plain = lambda: pa.pair_axis_attention_plain(q, k, v, h, d ** -0.5)
        pairs = lambda t: t.reshape(2, 2, 17550, h, d).permute(0, 2, 3, 1, 4).reshape(
            2 * 17550, h, 2, d).contiguous()
        qp, kp, vp = pairs(q), pairs(k), pairs(v)
        library = lambda: F.scaled_dot_product_attention(qp, kp, vp, scale=d ** -0.5)
        work = (_nbytes(q, k, v, q), 15.0 * 2 * 17550 * c, "fp32")
        results[name] = report(name, f"slice[2,2,17550,{c}] {h}x{d}", kern(), plain(), 1e-2,
                               1e-2, kern, plain, 20, library, work)

    # --- hazards, untimed.  Packed: M = 1,001 (a persistent warp's last
    # items, or a packed tile's, ragged) at dh 8, 32, 48, 128 and 256 (4
    # heads) for B5 / B5' at S = 1, 3, 7 (packed), 8, 13, 16 (a tile), 17,
    # 25 (long) and each width's long-body cap (`pa.MAX_S`: the most shared
    # memory a warp takes), B8 at 8, 13, 16, 25 and the cap, run twice and
    # bitwise equal (no sums across items).  B4: 1,001 rows at C = 384 (8 x
    # 48), 512 as 16 x 32 and 4 x 128, 3,072 as 24 x 128 (past the old
    # C <= 1,024: 4 heads a program, 6 grid columns), 200 as 25 x 8 (heads
    # padded to 32, widths to 8) and 1,024 as JAX's 128 heads of 8.
    # tol: as the timed rows.
    for name, d in pick([(n, d) for n in ("B5", "B8") for d in (8, 32, 48, 128, 256)]):
        cap = pa.MAX_S[pa.body_columns(d)]
        lengths = (1, 3, 7, 8, 13, 16, 17, 25, cap) if name == "B5" else (8, 13, 16, 25, cap)
        for s_ in lengths:
            q, k, v, g = (rnd(1001, s_, 4 * d).to(bf) for _ in range(4))
            tag = f"ragged[1001,{s_},4x{d}]"
            if name == "B5":
                check("B5" if s_ >= 8 else "B5'", tag, pa.tiny_seq_attention(q, k, v, 4, d ** -0.5),
                      pa.tiny_seq_attention_plain(q, k, v, 4, d ** -0.5), 1e-2, 2e-2)
                continue
            first = pa.tiny_seq_attention_bwd(q, k, v, g, 4, d ** -0.5)
            again = pa.tiny_seq_attention_bwd(q, k, v, g, 4, d ** -0.5)
            want = pa.tiny_seq_attention_bwd_plain(q, k, v, g, 4, d ** -0.5)
            for i, (got, ref) in enumerate(zip(first, want)):
                check("B8", f"{tag} out{i}", got, ref, _rel_compare(got, ref, 1e-2), 1e-2)
            check_ok("B8", f"{tag} run twice: bitwise equal",
                     all(torch.equal(a, b) for a, b in zip(first, again)))
    for name, d, h in pick([("B4", 48, 8), ("B4", 32, 16), ("B4", 128, 4), ("B4", 128, 24),
                            ("B4", 8, 25), ("B4", 8, 128)]):
        q, k, v = (rnd(1, 2, 1001, h * d).to(bf) for _ in range(3))
        check("B4", f"ragged[1,2,1001,{h * d}] {h}x{d}", pa.pair_axis_attention(q, k, v, h, 0.3),
              pa.pair_axis_attention_plain(q, k, v, h, 0.3), 1e-2, 1e-2)


TOKEN_CLASS = "tokens"
# the short-KV kernels at other token counts K and identity counts I, on the
# general key block (K = 32 with I <= 4 keeps the shipped one): their
# kernels line rows (name, kernel, K, I); B3 on the audio geometry, B2 on
# the perceiver's
TOKEN_ROWS = (("B3 K16", "B3", 16, 2), ("B3 K64", "B3", 64, 2), ("B3 I5", "B3", 32, 5),
              ("B3 I8", "B3", 32, 8), ("B3 K64 I5", "B3", 64, 5),
              ("B2 K16", "B2", 16, 2), ("B2 K64", "B2", 64, 2), ("B2 I3", "B2", 32, 3),
              ("B2 I5", "B2", 32, 5))
# the hazards' token and identity counts: one key (15 masked of its block),
# a ragged 16-key block (24, 33: one block past 32), a full 64-key block,
# and 100 (two chunks of 64, the second ragged: the two-pass softmax)
TOKEN_KS = (1, 4, 8, 16, 24, 33, 64, 100)
TOKEN_IS = (1, 3, 5, 8)


def token_kernel_phase(results: dict, rnd, report, check, bhsd, only) -> None:
    """The short-KV kernels at token counts K != 32 and identity counts I >
    4 (the general key block), against their plain versions: the rows of
    `TOKEN_ROWS` timed at their paths' shapes (B3 at [26, 1350, 3072] as 48
    x 64 heads, B2 at q [2, 17550, 2048] as 16 x 128), then every entry
    point, untimed, at each K of `TOKEN_KS` and I of `TOKEN_IS` at D = 64,
    128 and 256 (and 16 and 48 at K = 100, I = 5) over Sq = 1,000 in 3
    batches, both layouts and modes: a persistent block's share crosses a
    change of batch while its K/V is resident or streams (which of the two
    a (K, I, D) takes: `csrc/short_kv_attention.cu:general_geo`)."""
    import torch
    import torch.nn.functional as F
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(4321)
    firsts = None if only is None else {o.split()[0] for o in only}
    wanted = lambda kernel: firsts is None or kernel in firsts or TOKEN_CLASS in firsts

    # --- B3 on the audio geometry, q [26, 1350, 3072] (48 x 64 heads), and
    # B2 on the perceiver's, q [2, 17550, 2048] (16 x 128), at K tokens an
    # identity and I identities.
    # tol: as the K = 32, I = 2 rows.  bound: the bytes of q, K, V (0.3195
    # MB x I K at B3's shape), w and the output(s); operations 4 I K D a row
    # and head.  library: none for B3 (no single call weights the
    # identities' softmaxes); SDPA with the identities folded into the heads
    # for B2 (q repeated per identity before timing).
    for name, kernel, kk, n_id in (r for r in TOKEN_ROWS if wanted(r[1])):
        if kernel == "B3":
            g, sq, h, d = 26, 1350, 48, 64
            q = rnd(g, sq, h * d).to(bf)
            k, v = (rnd(g, n_id, h, kk, d).to(bf) for _ in range(2))
            w = torch.rand((g, sq, n_id), generator=gen, device=dev).to(bf)
            kern = lambda: skv.short_kv_attention_combined_flat(q, k, v, w, 0.125)
            plain = lambda: skv.short_kv_attention_combined_flat_plain(q, k, v, w, 0.125)
            library = None
            work = (_nbytes(q, k, v, w, q), 4.0 * g * n_id * h * sq * kk * d, "bf16")
            tag = f"slice[26,1350,3072] K={kk} I={n_id} w~U(0,1)"
        else:
            g, sq, h, d = 2, 17550, 16, 128
            q = rnd(g, sq, h * d).to(bf)
            k, v = (rnd(g, n_id, h, kk, d).to(bf) for _ in range(2))
            kern = lambda: skv.short_kv_attention_flat(q, k, v, d ** -0.5)
            plain = lambda: skv.short_kv_attention_flat_plain(q, k, v, d ** -0.5)
            qi = bhsd(q, h).unsqueeze(1).expand(g, n_id, h, sq, d).reshape(g, n_id * h, sq, d)
            ki, vi = k.reshape(g, n_id * h, kk, d), v.reshape(g, n_id * h, kk, d)
            library = lambda: F.scaled_dot_product_attention(qi, ki, vi)
            work = (_nbytes(q, k, v) + n_id * _nbytes(q), 4.0 * g * n_id * h * sq * kk * d,
                    "bf16")
            tag = f"slice[2,17550,2048] K={kk} I={n_id}"
        results[name] = report(name, tag, kern(), plain(), 1e-2, 2e-2, kern, plain, 20, library,
                               work)
        del q, k, v, library

    # --- hazards, untimed: every entry point at each (K, I, D), Sq = 1,000
    # over 3 batches (a ragged last 64-row tile), 48 heads at D <= 64, 16 at
    # 128, 8 at 256.
    # tol: as the timed rows, 1e-2 + 2e-2 |ref|, with the absolute part
    # taken of the reference's largest magnitude where that is over 1:
    # combined over I = 5 and 8 identities at K = 4 the outputs reach 4-8,
    # where one bf16 ulp is 3.1e-2, and the plain version rounds each
    # identity's output to bf16 before the combine (the kernel, as the TPU
    # body, sums them in fp32 and rounds once), so both sides round at that
    # scale.
    heads_of = lambda d: 48 if d <= 64 else 16 if d <= 128 else 8
    cases = [(d, kk, n_id) for d in (64, 128, 256) for kk in TOKEN_KS for n_id in TOKEN_IS]
    cases += [(16, 100, 5), (48, 100, 5)]
    entry = (("B14", "combined", "short_kv_attention_combined_qmajor", "q", True),
             ("B2c", "head-major combined", "short_kv_attention_combined", "h", True),
             ("B3", "flat combined", "short_kv_attention_combined_flat", "f", True),
             ("B14", "per-id", "short_kv_attention_qmajor", "q", False),
             ("B2h", "head-major per-id", "short_kv_attention", "h", False),
             ("B2", "flat per-id", "short_kv_attention_flat", "f", False))
    entry = [e for e in entry if wanted(e[0])]
    if not entry:
        return
    g, sq = 3, 1000
    for d, kk, n_id in cases:
        h = heads_of(d)
        k, v = (rnd(g, n_id, h, kk, d).to(bf) for _ in range(2))
        w = torch.rand((g, sq, n_id), generator=gen, device=dev).to(bf)
        q_q, q_h = rnd(g, sq, h, d).to(bf), rnd(g, h, sq, d).to(bf)
        qs = {"q": q_q, "h": q_h, "f": q_q.reshape(g, sq, h * d)}
        for name, what, fn, lay, combined in entry:
            args = (qs[lay], k, v, w) if combined else (qs[lay], k, v)
            want = getattr(skv, f"{fn}_plain")(*args, d ** -0.5)
            check(name, f"ragged {what} [G={g},Sq={sq},H={h},D={d}] K={kk} I={n_id}",
                  getattr(skv, fn)(*args, d ** -0.5), want,
                  1e-2 * max(1.0, float(want.float().abs().max())), 2e-2)


STREAM_CLASS = "stream"
# B5, B5' and B8 past each body's cap (the streamed body): their kernels
# line rows (name, kernel, phase-2 tag of the timed row)
STREAM_ROWS = (("B5 S201", "B5", "ragged[1001,201,512]"),
               ("B5' S201", "B5'", "ragged[1001,201,512]"),
               ("B8 S201", "B8", "ragged[1001,201,512]"),
               ("B5 dh256 S49", "B5", "cap+1[1001,49,2x256]"),
               ("B8 dh256 S49", "B8", "cap+1[1001,49,2x256]"))
# the streamed rows' shapes (tag, M, S, heads, dh): one past each body's cap,
# 201 (801 frames) and 400 (1,597 frames) at a ragged M, and 400 at the
# full-resolution M, where [M, S, C] passes 2^31 bytes
STREAM_SHAPES = (("cap+1[1001,193,8x64]", 1001, 193, 8, 64),
                 ("cap+1[1001,97,4x128]", 1001, 97, 4, 128),
                 ("cap+1[1001,49,2x256]", 1001, 49, 2, 256),
                 ("ragged[1001,201,512]", 1001, 201, 8, 64),
                 ("ragged[1001,400,512]", 1001, 400, 8, 64),
                 ("slice[5400,400,512]", 5400, 400, 8, 64))
# B5 and B8 past what a block's shared memory holds of an item, untimed:
# (tag, M, S, heads, dh).  The first three stream an item's blocks in both
# directions: the forward's key blocks, and both B8 kernels' ring (4, 3 and
# 2 slots; from S = 833 / 705 at 64 columns, 385 / 321 at 128, 129 at 256,
# q-major / kv-major).  At 10 x 48 only B8's kv-major kernel streams; 32,
# 48 and 200 columns ride the 64 and 256 bodies, clipped at the true dh,
# 3 x 200 both resident (one slot) and streamed.
STREAM_PAST_SMEM = (("kv-streamed[9,1100,8x64]", 9, 1100, 8, 64),
                    ("kv-streamed[9,601,4x128]", 9, 601, 4, 128),
                    ("kv-streamed[9,301,2x256]", 9, 301, 2, 256),
                    ("narrow[9,200,16x32]", 9, 200, 16, 32),
                    ("narrow[9,777,10x48]", 9, 777, 10, 48),
                    ("between[9,70,3x200]", 9, 70, 3, 200),
                    ("between kv-streamed[9,150,3x200]", 9, 150, 3, 200))


def stream_kernel_phase(results: dict, rnd, report, report_all, check, check_ok, bhsd,
                        only) -> None:
    """B5, B5' (`packed_head_attention` on the [M, S*H, dh] view) and B8
    on the streamed body, past each body's cap in `MAX_S`, against their
    plain versions at every shape of `STREAM_SHAPES`, timed; B5 and B8 run
    twice at S = 201 and at dh 256, bitwise equal (no sums across units).
    Beside each B5 row, the yardstick: the port's B11 forward (bshd, bare)
    on the same memory, timed; beside each B8 row, the port's fused flash
    backward (B12 + B13, bshd) on the same memory, fed the O and LSE of
    B11's forward (untimed), timed.  Then B5 and B8, untimed, each against
    its plain version and run twice (bitwise equal) at `STREAM_PAST_SMEM`,
    where an item's blocks pass a block's shared memory and stream, and at
    widths below and between the bodies'.
    The plain versions run 256 rows of M at a time (the same function; the
    fp32 scores of a whole [5400, 8, 400, 400] call would not fit)."""
    import torch
    import torch.nn.functional as F
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import packed_attention as pa
    from bindyouravatar_tpu_torch.profile_step import kernel_records

    bf = torch.bfloat16
    firsts = None if only is None else {o.split()[0] for o in only}
    wanted = lambda kernel: firsts is None or kernel in firsts or STREAM_CLASS in firsts
    keys = {(kernel, tag): name for name, kernel, tag in STREAM_ROWS}

    def by_rows(fn, *ts, step=256):
        """fn over slices of `step` rows of M, concatenated."""
        parts = [fn(*(t[i:i + step] for t in ts)) for i in range(0, ts[0].shape[0], step)]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(p) for p in zip(*parts))
        return torch.cat(parts)

    # tol: as the long bodies' rows (the same numerics, the same sums in
    # the same order).  bound: the bytes of the inputs and outputs; the
    # operations 4 (forward) or 10 (backward) M H S^2 dh, bf16 (the
    # products run on the tensor cores).  library: SDPA on [M, H, S, dh]
    # copies (permuted before timing); B8: its autograd backward, timed
    # alone.
    for kernel in ("B5", "B5'", "B8"):
        if not wanted(kernel):
            continue
        for tag, m, s_, h, d in STREAM_SHAPES:
            assert pa.kernel_body(s_, h * d, h, kernel == "B8") == "stream", (kernel, tag)
            c, sc = h * d, d ** -0.5
            runs = 3 if m > 1001 else 10
            q, k, v = (rnd(m, s_, c).to(bf) for _ in range(3))
            qh, kh, vh = bhsd(q, h), bhsd(k, h), bhsd(v, h)
            key = keys.get((kernel, tag))
            if kernel == "B8":
                g = rnd(m, s_, c).to(bf)
                qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
                oh = F.scaled_dot_product_attention(qh, kh, vh, scale=sc)
                gh = bhsd(g, h)
                lib = lambda: torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True)
                kern = lambda: pa.tiny_seq_attention_bwd(q, k, v, g, h, sc)
                plain = lambda: by_rows(
                    lambda *t: pa.tiny_seq_attention_bwd_plain(*t, h, sc), q, k, v, g)
                work = (_nbytes(q, k, v, g, q, k, v), 10.0 * m * h * s_ * s_ * d, "bf16")
                first, want = kern(), plain()
                r = report_all(kernel, tag, first, want, (1e-2,) * 3, kern, plain, runs,
                               lib, work)
                if m == 1001 and s_ in (201, 49):
                    check_ok(kernel, f"{tag} run twice: bitwise equal",
                             all(torch.equal(a, b) for a, b in zip(first, kern())))
                # where the row's time goes: each of the two kernels'
                # records (the q-major statistics + dQ, the kv-major dK + dV)
                split = "; ".join(
                    f"{'q-major' if 'dq_kernel' in n else 'kv-major' if 'dkv_kernel' in n else n[:40]}"
                    f" {ms_:.4f} ms x{c / runs:g}"
                    for n, (c, ms_) in sorted(kernel_records(kern, runs).items()))
                print(f"  B8 {tag} per kernel (records, median): {split}", flush=True)
                # the yardstick: the port's own fused flash backward (B12 +
                # B13, bshd) on the same memory as [M, S, H, dh], fed the O
                # and LSE of B11's forward (not timed); timed, not recorded
                # as the row
                q4, k4, v4, g4 = (t.view(m, s_, h, d) for t in (q, k, v, g))
                o4, lse4 = fa.flash_attention_fwd(q4, k4, v4, "bshd", sc)
                b1213 = lambda: fa.flash_attention_bwd(q4, k4, v4, o4, g4, lse4, "bshd", sc)
                report_all("B12+B13", f"{tag} bshd yardstick",
                           tuple(t.reshape(m, s_, c) for t in b1213()), want, (1e-2,) * 3,
                           b1213, None, runs, None, work, plain_ms=r["plain_ms"])
                del g, oh, gh, first, want, q4, k4, v4, g4, o4, lse4
            else:
                if kernel == "B5":
                    kern = lambda: pa.tiny_seq_attention(q, k, v, h, sc)
                    plain = lambda: by_rows(
                        lambda *t: pa.tiny_seq_attention_plain(*t, h, sc), q, k, v)
                else:
                    packed = [t.reshape(m, s_ * h, d) for t in (q, k, v)]
                    kern = lambda: pa.packed_head_attention(*packed, h, sc)
                    plain = lambda: by_rows(
                        lambda *t: pa.packed_head_attention_plain(*t, h, sc), *packed)
                lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=sc)
                work = (_nbytes(q, k, v, q), 4.0 * m * h * s_ * s_ * d, "bf16")
                got, want = kern().reshape(m, s_, c), plain().reshape(m, s_, c)
                r = report(kernel, tag, got, want, 1e-2, 2e-2, kern, plain, runs, lib, work)
                if kernel == "B5" and m == 1001 and s_ in (201, 49):
                    check_ok(kernel, f"{tag} run twice: bitwise equal", torch.equal(got, kern()))
                if kernel == "B5":
                    # the yardstick: the port's own B11 forward (bshd, no
                    # LN or RoPE) on the same memory as [M, S, H, dh], the
                    # same function with the LSE beside it; timed, not
                    # recorded as a row
                    q4, k4, v4 = (t.view(m, s_, h, d) for t in (q, k, v))
                    b11 = lambda: fa.flash_attention_fwd(q4, k4, v4, "bshd", sc)[0]
                    report("B11", f"{tag} bshd yardstick", b11().reshape(m, s_, c), want, 1e-2,
                           2e-2, b11, None, runs, None, work, plain_ms=r["plain_ms"])
                del got, want
            if key is not None:
                results[key] = r
            del q, k, v, qh, kh, vh
            torch.cuda.empty_cache()
    # tol: as the timed rows (B8: 1e-2 of each gradient's largest
    # magnitude, + 1e-2 relative)
    for tag, m, s_, h, d in STREAM_PAST_SMEM:
        sc = d ** -0.5
        q, k, v, g = (rnd(m, s_, h * d).to(bf) for _ in range(4))
        if wanted("B5"):
            assert pa.kernel_body(s_, h * d, h) == "stream", ("B5", tag)
            got = pa.tiny_seq_attention(q, k, v, h, sc)
            check("B5", tag, got, pa.tiny_seq_attention_plain(q, k, v, h, sc), 1e-2, 2e-2)
            check_ok("B5", f"{tag} run twice: bitwise equal",
                     torch.equal(got, pa.tiny_seq_attention(q, k, v, h, sc)))
        if wanted("B8"):
            assert pa.kernel_body(s_, h * d, h, True) == "stream", ("B8", tag)
            got = pa.tiny_seq_attention_bwd(q, k, v, g, h, sc)
            want = pa.tiny_seq_attention_bwd_plain(q, k, v, g, h, sc)
            for i, (a, b) in enumerate(zip(got, want)):
                check("B8", f"{tag} out{i}", a, b, _rel_compare(a, b, 1e-2), 1e-2)
            check_ok("B8", f"{tag} run twice: bitwise equal",
                     all(torch.equal(a, b) for a, b in
                         zip(got, pa.tiny_seq_attention_bwd(q, k, v, g, h, sc))))


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


def _multi_id_launches(ids: int, stabs: int, b5: int, b5p: int) -> dict:
    """B4, B5 and B5' launches of `stabs` multi-ID STAB attentions over
    `ids` identities, as `models/router.py` dispatches them (B4 at 2
    identities, B5' below 8, B5 from 8), added to the temporal STABs' `b5`
    (B5) and `b5p` (B5')."""
    return {"B4": stabs if ids == 2 else 0, "B5": b5 + (stabs if ids >= 8 else 0),
            "B5'": b5p + (stabs if ids != 2 and ids < 8 else 0)}


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
      blocks: 2 x B10 fwd per block forward and 2 x B10 bwd per block; the
        attention is B7 (forward, backward) when the heads pair in 128
        lanes, else B11 forward and B12 + B13 backward;
      face layer: B2; per STAB: B7 (spatial, when H*W >= 1024 and its head
        dim is a multiple of 64, JAX's rule; else the plain attention), B5
        + B8 (temporal, T >= 8; else B5' and the plain vjp), B4 (multi-ID;
        at I != 2 identities `_multi_id_launches`, B8 from 8); fused
        LayerNorms (B6 forward, B9 backward):
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
    spatial = stabs if h * w >= 1024 and (r.feat_dim // r.attn_heads) % 64 == 0 else 0
    temporal = t >= 8
    face_ln = n_ca * (2 + 2 + 1 + 4 * n_st)
    n_audio = a.num_layers if c.is_train_audio else 0
    audio_ln = n_audio if a.dim % 128 == 0 else 0
    paired = c.num_attention_heads % max(1, 128 // c.attention_head_dim) == 0
    flat, layout = (c.num_layers, 0) if paired else (0, c.num_layers)
    hln = c.num_layers                                     # B10 takes any row width
    multi = _multi_id_launches(c.num_ids, stabs, stabs if temporal else 0,
                               0 if temporal else stabs)
    per = {"B1": 0, "B2": n_ca * g_mult, "B3": n_audio * g_mult,
           **{k: v * g_mult for k, v in multi.items()},
           "B6": (audio_ln + face_ln) * g_mult + int(n_audio > 0 and a.audio_dim % 128 == 0),
           "B7 fwd": flat * a_mult + spatial * g_mult, "B7 bwd": flat + spatial,
           "B8": (stabs if temporal else 0) + (stabs if c.num_ids >= 8 else 0),
           "B9": audio_ln + face_ln,
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
    the 10% of entries replaced by uniforms.  Past 2 identities (phase 3i)
    an audio track each and the teacher from I equal column bands."""
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
    if c.num_ids == 2:
        clean = torch.stack([left, right], -1)
    else:
        band = (col * c.num_ids // gw)[:, None] == torch.arange(c.num_ids, device=dev)
        clean = band.float().expand(t, gh, gw, c.num_ids)
    clean = clean.reshape(1, t * gh * gw, c.num_ids).repeat(b, 1, 1)
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
        audio_embeds=rnd(b, c.num_ids, n_af, a.blocks, a.audio_dim),
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


# set in `_References`' worker thread (`_watch_tiny_seq` counts no call there)
_REFERENCE_THREAD = threading.local()


def _reference_thread(threads: int) -> None:
    import torch

    _REFERENCE_THREAD.on = True
    torch.set_num_threads(threads)


class _References:
    """The CPU's fp32 references of the 2-layer full-width DiT cases
    (phases 3e, 3f, 3g, 3i and 12c: `_dit_head_case`, `_long_clip_case`),
    run on a worker thread of their own while the card goes on with the
    later phases.  `add(start)` queues a case: `start()` runs its card
    side in the calling thread (the draw, the card's forward and
    micro-batch, their launch counts) and returns its verdict, which the
    worker runs (the reference, the comparison and the case's line; no
    CUDA tensor) and which returns whether the case passed.  `pump()`
    starts queued cases while fewer than `ahead` verdicts are unfinished
    (each holds its fp32 reference model on the host), `quiet()` waits
    for every started verdict, `drain()` starts the rest and returns
    whether every verdict passed.  A verdict's line prints when it ends,
    among the later phases' lines."""

    def __init__(self, ahead: int = 2):
        import collections

        import torch

        self.queued, self.started, self.ahead = collections.deque(), [], ahead
        # the worker's intra-op threads leave the launching thread a core
        self.pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="reference", initializer=_reference_thread,
            initargs=(max(1, torch.get_num_threads() - 1),))

    def add(self, start) -> None:
        self.queued.append(start)

    def _busy(self) -> list:
        return [f for f in self.started if not f.done()]

    def _start(self) -> None:
        verdict = self.queued.popleft()()
        if verdict is not None:
            self.started.append(self.pool.submit(verdict))

    def pump(self) -> None:
        while self.queued and len(self._busy()) < self.ahead:
            self._start()

    def quiet(self) -> None:
        concurrent.futures.wait(self.started)

    def drain(self) -> bool:
        while self.queued:
            busy = self._busy()
            if len(busy) >= self.ahead:
                concurrent.futures.wait(busy, return_when=concurrent.futures.FIRST_COMPLETED)
            self._start()
        try:
            return all([f.result() for f in self.started])
        finally:
            self.pool.shutdown()


def _dit_head_case(heads: int, d: int, face: bool = False, router_heads: int | None = None,
                   ids: int = 2, face_tokens: int | None = None,
                   audio_tokens: int | None = None) -> tuple:
    """One 2-layer DiT at full width with `heads` x `d` heads (dim heads *
    d), 8 latent frames, 16 + 1,024 tokens, LoRA r8.  Audio only (phases
    3e, 3f): its audio layers pinned to the 5B's 48 x 64 attention heads
    over the DiT's width.  `face` (phase 3g): face + audio with the
    sub-configurations `DiT.create` derives, so the audio layers take the
    DiT's own head split (B3 at dh `d`), the perceiver its 16 x 128 heads
    (B2 at 128) and the router its STAB of 8 x 64 over 512 channels, or
    `router_heads` heads of 512 / `router_heads` (B5, B8 and B4 at that
    dh).  Phase 3i: `ids` identities (`DiTConfig.num_ids`; the multi-ID
    STAB then takes B5' below 8 and B5 from 8, B4 only at 2),
    `face_tokens` the LFE's and perceivers' tokens an identity
    (`lfe_num_tokens`: B2 at that K) and `audio_tokens` the audio
    layers' (`AudioConfig.context_tokens`, the rest of the audio
    configuration derived: B3 at that K).  On the card (bf16) against the
    same weights on the CPU (plain versions, fp32):
      * the serving forward (`fuse_qk_norm`: B1 with the QK-LN and RoPE
        fused where the DiT takes it, at head dims 32, 64 and 128 with heads
        that pack; else B10 and B7's forward or B11), its output, and the
        attention kernel launched once a block;
      * one Stage-3 micro-batch (`Trainer.grads_and_metrics`: B10 at the
        head dim, then B7 forward and backward where the heads pair, else
        B11 and B12 + B13), its metrics and every trainable gradient (the
        face path's within phase 3b's 10%: its bf16 floor, phase 12c), the
        launches those of `train_launches`.
    Runs the card's side now and returns (the forward's launches, the
    micro-batch's launches, the verdict): the verdict runs the CPU's
    reference (no CUDA tensor: a `_References` worker runs it) and returns
    (ok, the gradients' relative L2 errors by name)."""
    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.config import (AudioConfig, DiTConfig, LFEConfig,
                                                 RouterConfig, SchedulerConfig, TrainConfig)
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.ops.flash_attention import flat_heads_pack
    from bindyouravatar_tpu_torch.ops.scheduler import Schedule
    from bindyouravatar_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    dim = heads * d
    base = dict(num_attention_heads=heads, attention_head_dim=d, in_channels=48,
                out_channels=16, time_embed_dim=64, text_embed_dim=128, num_layers=2,
                sample_width=32, sample_height=16, sample_frames=29, max_text_seq_length=16,
                lora_rank=8, lora_alpha=8.0, is_train_face=face, num_ids=ids)
    if face_tokens is not None:
        base["lfe_num_tokens"] = face_tokens
    if face:
        # `DiT.create`'s own audio and LFE configs (the audio tokens set
        # where asked); its router's, with the STAB's heads set where asked
        c0 = DiTConfig(**base)
        audio = None if audio_tokens is None else dataclasses.replace(
            DiT.create(c0, device="meta").audio_cfg, context_tokens=audio_tokens)
        sub = (audio, None if router_heads is None else RouterConfig(
            num_layers=c0.num_ca, q_k_dim=c0.lfe_final_output_dim,
            num_id_token=c0.lfe_num_tokens, attn_heads=router_heads), None)
    else:
        sub = (AudioConfig(dim=dim, audio_dim=128, num_attention_heads=48,
                           attention_head_dim=64, num_layers=2, blocks=2, intermediate_dim=64,
                           context_tokens=32),
               RouterConfig(num_layers=1, q_k_dim=512, num_heads=4, num_id_token=32,
                            attn_heads=2),
               LFEConfig(dim=128, depth=5, dim_head=64, heads=2, num_id_token=2,
                         num_queries=32, output_dim=512, id_embed_dim=64, vit_dim=64))
    gen = torch.Generator().manual_seed(13)
    # the reference's weights (face + audio: ~1.5 B parameters, 1.24 B of
    # them the audio projection's) are drawn on the card and copied to the
    # CPU, where the generator would take seconds a case
    draw = torch.Generator("cuda").manual_seed(13)
    make = lambda dtype, dev, fuse, generator=None: DiT.create(
        DiTConfig(dtype=dtype, fuse_qk_norm=fuse, **base), *sub, device=dev,
        generator=generator)
    ref = make(torch.float32, "cuda", False, draw)
    with torch.no_grad():        # LoRA B off zero, so LoRA A takes gradients too
        for blk in ref.blocks:
            for name in ("to_q_lora_B", "to_k_lora_B"):
                getattr(blk.attn1, name).normal_(0.0, 0.02, generator=draw)
    # the card's models load the draw where it lies (the same fp32 values
    # as the host's copy, without two host-to-card copies of it)
    sd = ref.state_dict()
    ref = ref.to("cpu")
    cpu_s = {"draw": time.perf_counter() - t0}      # the CPU reference's seconds
    c, a, lf = ref.cfg, ref.audio_cfg, ref.lfe_cfg
    fused = d in (32, 64, 128) and flat_heads_pack(d, heads)
    paired = heads % max(1, 128 // d) == 0
    attn = "B1" if fused else "B7 fwd" if paired else "B11"

    # the serving forward's inputs
    rng = np.random.default_rng(13)
    n_af = c.sample_frames + a.window_size - a.window_stride
    inputs = dict(latents=rng.normal(size=(1, c.latent_frames, 48, 16, 32)),
                  text_embeds=rng.normal(size=(1, 16, 128)), timesteps=np.array([499.0]),
                  audio_embeds=rng.normal(size=(1, c.num_ids, n_af, a.blocks, a.audio_dim)))
    if face:
        inputs.update(id_cond=rng.normal(size=(1, c.num_ids, lf.id_embed_dim)),
                      id_vit_hidden=rng.normal(size=(1, c.num_ids, lf.num_scales, 17,
                                                     lf.vit_dim)))
    # the micro-batch's batch and draws, made before either side runs
    tcfg = TrainConfig(grad_accum_steps=1)
    cpu_tr = Trainer(ref, Schedule.create(SchedulerConfig()), tcfg)
    cpu_tr.init_state()
    batch = _train_batch(ref, 1, gen, "cpu", vit_tokens=17)
    if not face:
        for key in ("id_cond", "id_vit_hidden", "teacher_clean", "teacher_noisy"):
            del batch[key]
    draws = cpu_tr.draw(batch, gen)
    if face:     # keep the teacher mask, so the perceivers' gradients are compared
        draws["keep_mask"][:] = True

    def forward(model, dev):
        t = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in inputs.items()}
        return model.apply(t.pop("latents"), t.pop("text_embeds"), t.pop("timesteps"),
                           model.rope(16 * 8, 32 * 8, c.latent_frames, device=dev), **t)[0]

    def reference():
        # the forward on the train step's reference model (its plain path
        # in fp32 is the fused path's function), then the micro-batch
        t1 = time.perf_counter()
        with torch.inference_mode():
            out = forward(ref, "cpu")
        t2 = time.perf_counter()
        result = cpu_tr.grads_and_metrics(batch, [draws])
        cpu_s.update({"forward": t2 - t1, "micro-batch": time.perf_counter() - t2})
        return out, result

    # the card's side now; the CPU's reference in `verdict`, which touches
    # no CUDA tensor (a `_References` worker runs it while the card goes on)
    to_gpu = lambda dd: {k: None if v is None else v.cuda() for k, v in dd.items()}
    with torch.inference_mode():      # the serving forward
        model = make(torch.bfloat16, "cuda", True)
        model.load_state_dict(sd)
        torch.cuda.synchronize()
        _reset_launches()
        out_g = forward(model, "cuda")
        torch.cuda.synchronize()
        fwd_counts = _read_launches()
        out_g = out_g.float().cpu()
        del model
    # one Stage-3 micro-batch: B10, B7 or B11 and B12 + B13
    gpu = make(torch.bfloat16, "cuda", False)
    gpu.load_state_dict(sd)
    gpu_tr = Trainer(gpu, Schedule.create(SchedulerConfig()), tcfg)
    gpu_tr.init_state()
    torch.cuda.synchronize()
    _reset_launches()
    grads_g, m_g = gpu_tr.grads_and_metrics(to_gpu(batch), [to_gpu(draws)])
    torch.cuda.synchronize()
    counts = _read_launches()
    grads_g = {k: v.float().cpu() for k, v in grads_g.items()}
    m_g = {k: float(v) for k, v in m_g.items()}
    want = train_launches(gpu, 1)
    del gpu, gpu_tr, sd
    torch.cuda.empty_cache()
    card_s = time.perf_counter() - t0

    want_fwd = {k: c.num_layers if k == attn else 0 for k in ("B1", "B7 fwd", "B11")}
    want_fwd["B10 fwd"] = 0 if fused else 2 * c.num_layers
    want_fwd["B3"] = a.num_layers
    if face:     # T = 8: the temporal STABs on B5's one-tile body
        stabs = c.num_ca * ref.router_cfg.num_attention_layers
        want_fwd.update({"B2": c.num_ca, **_multi_id_launches(c.num_ids, stabs, stabs, 0)})
    train_attn = "B7 fwd" if paired else "B11"

    def verdict():
        t1 = time.perf_counter()
        out_c, (grads_c, m_c) = reference()
        outs = [out_c.float(), out_g]
        # tol: bf16 activations and weights through 2 blocks against fp32
        scale = float(outs[0].abs().max())
        f_err, _, f_ok = _compare(outs[1], outs[0], 0.05 * scale, 0.05)
        f_rel = _rel_l2(outs[1], outs[0])
        f_ok &= ({k: fwd_counts[k] for k in want_fwd} == want_fwd and f_rel <= 0.02
                 and bool(outs[1].isfinite().all()))

        # tol: metrics within 5% + 1e-3 (as phase 3b); the gradients within
        # 3% relative L2 each, the key biases (true gradient 0) left out, the
        # face path's within phase 3b's 10% (its bf16 floor: 3.45-4.13% in
        # phase 12c)
        m_err = {k: abs(m_g[k] - float(m_c[k])) for k in m_c}
        m_ok = all(m_err[k] <= 1e-3 + 0.05 * abs(float(m_c[k])) for k in m_c)
        g_err = {}
        for k, gc_ in grads_c.items():
            if k.endswith("to_k.bias"):
                continue
            norm = float(gc_.norm())
            diff = float((grads_g[k] - gc_).norm())
            g_err[k] = diff / norm if norm > 0 else diff
        worst = sorted(((k, e) for k, e in g_err.items() if not _face_path(k)),
                       key=lambda kv: -kv[1])[:3]
        worst_face = sorted(((k, e) for k, e in g_err.items() if _face_path(k)),
                            key=lambda kv: -kv[1])[:3]
        g_ok = all(e <= (0.1 if _face_path(k) else 0.03) for k, e in g_err.items())
        c_ok = ({k: counts[k] for k in want} == want and counts[train_attn] > 0
                and counts["B10 fwd"] > 0 and counts["B3"] > 0)
        ok = f_ok and m_ok and g_ok and c_ok
        shown = lambda cnt, w: " ".join(f"{k}={cnt[k]} (want {w[k]})" for k in w
                                        if w[k] or cnt[k])
        rc = ref.router_cfg
        what = ("face + audio, derived audio heads "
                f"{a.num_attention_heads} x {a.attention_head_dim}, router STAB "
                f"{rc.attn_heads} x {rc.feat_dim // rc.attn_heads}, I = {c.num_ids}, K = "
                f"{c.lfe_num_tokens} face / {a.context_tokens} audio tokens" if face
                else "audio only")
        print(f"head dim {d} ({heads} x {d} heads, dim {dim}, 2 layers, {what}, 16 + 1024 "
              f"tokens): forward cuda-bf16 vs cpu-fp32 relative L2 {f_rel:.3e} (tol 0.02), "
              f"max_abs_err={f_err:.3e} (ref max {scale:.3e}, tol 0.05 of it + 0.05*|ref|), "
              f"launches {shown(fwd_counts, want_fwd)}; micro-batch loss "
              f"{m_g['loss']:.5f} / {float(m_c['loss']):.5f}, metrics max |d| "
              + " ".join(f"{k}={v:.2e}" for k, v in m_err.items())
              + f" (tol 1e-3+0.05*|ref|); {len(g_err)} trainable gradients, worst relative L2 "
              + " ".join(f"{k}={v:.3e}" for k, v in worst) + " (tol 0.03)"
              + ("; the face path's " + " ".join(f"{k}={v:.3e}" for k, v in worst_face)
                 + " (tol 0.1)" if face else "") + "; launches "
              + shown(counts, want) + f"; card side {card_s:.1f} s, the CPU reference "
              + ", ".join(f"{k} {v:.1f}" for k, v in cpu_s.items())
              + f", verdict {time.perf_counter() - t1:.1f} s {'ok' if ok else 'FAILED'}",
              flush=True)
        return ok, g_err

    return fwd_counts, counts, verdict


def _verdict_ok(verdict):
    """A `_dit_head_case` / `_long_clip_case` verdict that returns its ok alone."""
    return lambda: verdict()[0]


def head_dim_phase(launches: dict, refs: _References) -> None:
    """Phase 3e: the flat kernels at head dims 128 and 32 inside the model,
    `_dit_head_case` at 24 x 128 and at 96 x 32 heads (dim 3072; both pair
    in 128 lanes: B1 in the forward, B7 and B10 in the micro-batch), queued
    on `refs`.  `launches` takes, per head dim, B1's launches in the
    forward and B7's in the micro-batch (`B1 dh128`, `B7 fwd dh128`, ...)
    when the case's card side runs."""
    def start(d):
        fwd, train, verdict = _dit_head_case(3072 // d, d)
        launches.update({f"B1 dh{d}": fwd["B1"], f"B7 fwd dh{d}": train["B7 fwd"],
                         f"B7 bwd dh{d}": train["B7 bwd"]})
        return _verdict_ok(verdict)

    for d in (128, 32):
        refs.add(lambda d=d: start(d))


def head_dim_model_phase(launches: dict, refs: _References) -> None:
    """Phase 3f: the head dims the flash kernels and B10 took last, inside
    the model, `_dit_head_case` at 192 x 16 (flat, 8 heads to 128 lanes),
    12 x 256 (flat, the 256-column bodies), 189 x 16 (dim 3,024: B11 and
    B12 + B13 at D = 16) and 47 x 64 (dim 3,008: the unpaired-head DiT at
    full width, B11 and B12 + B13 at D = 64).  None takes the fused B1 at
    inference.  `launches` takes the micro-batches' launches of the kernels
    line's dh16 / dh256 rows (B10's summed over both 16-wide DiTs).  The
    cases are queued on `refs`, as phase 3e's."""
    def start(heads, d, rows):
        _, train, verdict = _dit_head_case(heads, d)
        for name in rows:
            key = f"{name} dh{d}"
            launches[key] = launches.get(key, 0) + train[name]
        return _verdict_ok(verdict)

    for case in ((192, 16, ("B7 fwd", "B7 bwd", "B10 fwd", "B10 bwd")),
                 (12, 256, ("B7 fwd", "B7 bwd", "B10 fwd", "B10 bwd")),
                 (189, 16, ("B11", "B12+B13", "B10 fwd", "B10 bwd")),
                 (47, 64, ())):
        refs.add(lambda case=case: start(*case))


def head_dim_face_phase(args, launches: dict, refs: _References) -> bool:
    """Phase 3g: the face + audio DiT that `DiT.create` builds, at the head
    splits the flash kernels take (`_dit_head_case(face=True)`): 24 x 128,
    96 x 32, 192 x 16 and 12 x 256 heads, the audio layers derived (B3 at
    the DiT's dh), the perceiver at 16 x 128 (B2), the router's STAB at 8 x
    64; then at 24 x 128 with `RouterConfig(attn_heads=4)` and
    `attn_heads=16` over the derived 512 channels (B5, B8 and B4 at dh 128
    and 32).  Then one 42-layer request at 24 x 128
    (`head_dim_serving_request`), at once; the cases are queued on `refs`,
    as phase 3e's.  `launches` takes the B3, B4, B5 and B8 launches of the
    kernels line's width rows (forward + micro-batch)."""
    add = lambda key, n: launches.__setitem__(key, launches.get(key, 0) + n)

    def start(heads, d, rh):
        fwd, train, verdict = _dit_head_case(heads, d, face=True, router_heads=rh)
        add(f"B3 dh{d}", fwd["B3"] + train["B3"])
        if rh is not None:
            for name in ("B4", "B5", "B8"):
                add(f"{name} dh{512 // rh}", fwd[name] + train[name])
        return _verdict_ok(verdict)

    for case in ((24, 128, None), (96, 32, None), (192, 16, None), (12, 256, None),
                 (24, 128, 4), (24, 128, 16)):
        refs.add(lambda case=case: start(*case))
    return head_dim_serving_request(args)


def head_dim_serving_request(args) -> bool:
    """Phase 3g's request: the 5B geometry with 24 x 128 heads, the audio
    layers' heads derived (24 x 128: B1 and B3 at dh 128)
    (`_model_request`).  Phase 4's first request is the 48 x 64 model's
    beside it."""
    return _model_request(args, f"head dims, {args.request_layers}-layer request (phase 3g; "
                          f"24 x 128 heads", 40, heads=24, layers=args.request_layers)


def _model_request(args, what: str, seed: int, **model) -> bool:
    """One request on the 5B geometry (face + audio, 226 + 17,550
    tokens) with `_serving_model`'s settings `model`, bf16 weights drawn on
    the card: `--steps` DPM++ steps at 49 x 480 x 720 through the
    `InferenceServer`, whole decode: the clip finite [1, 49, 3, 480, 720],
    exact launches, s a denoise step (one batch-2 CFG forward and the
    scheduler's update), `denoise_s`, `decode_s`, peak memory.  `what`
    opens the printed line."""
    import torch
    from bindyouravatar_tpu_torch.serving import InferenceServer

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    pipe = _serving_model(args, args.steps, **model)
    dit, pc = pipe.dit, pipe.cfg
    fwd = args.steps * (2 if pc.cfg_microbatch else 1)
    server = InferenceServer(pipe, dev)
    try:
        req = _serving_request(pipe, args.seed + seed, what)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        r = server.submit(req).result(timeout=1200)
        torch.cuda.synchronize()
        counts = _read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        server.close()
    ok = _video_ok("request " + " ".join(f"{k}={v:.3f}" for k, v in r.timings.items()),
                   r.video, (1, pc.num_frames, 3, pc.height, pc.width))
    ok &= _counts_ok("request", counts, _serving_want(dit, fwd, 0, 1))
    a = dit.audio_cfg
    print(f"{what}, audio layers {a.num_attention_heads} x {a.attention_head_dim}, "
          f"{dit.cfg.num_ids} identities, {dit.cfg.lfe_num_tokens} face / {a.context_tokens} "
          f"audio tokens, face + audio, 49 x 480 x 720, {args.steps} DPM++ steps, whole "
          f"decode): {r.timings['denoise_s'] / args.steps:.4f} s a denoise step, peak "
          f"{peak:.2f} GiB, {time.perf_counter() - t0:.1f} s with the draw "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    del pipe, dit, server, r
    torch.cuda.empty_cache()
    return ok


# phase 3i's settings: (tag, identities I, face tokens K_f, audio tokens K_a):
# (a) the multi-ID STAB on B5' at S = 3; (b) the first I past the shipped
# body's 4 and the largest I K (B3 at 5 x 64); (c) JAX's tiny tier's token
# counts at the 5B width, on B4's pair path.  K_f is 24 and 56 where 16
# and 64 were asked: the router's 3-D sincos table spans K_f x 16 channels
# in thirds whose width must be even (`models/router.py:_router_pos_emb`,
# a copy of JAX's), which 16 and 64 tokens (thirds of 85 and 341) fail in
# both packages.  Its STAB then runs at dh 48 (a), 112 (b) and 16 (c).
TOKEN_SETTINGS = (("a", 3, 24, 16), ("b", 5, 56, 64), ("c", 2, 8, 4))


def token_phase(args, launches: dict, refs: _References) -> bool:
    """Phase 3i: the face + audio DiT that `DiT.create` builds at other
    token and identity counts, 2 layers at full width (dim 3072, 48 x 64
    heads, the audio heads derived), 16 + 1,024 tokens, in each setting of
    `TOKEN_SETTINGS` (`_dit_head_case`: the serving forward within 2% and
    one Stage-3 micro-batch's gradients within 3% of the CPU's fp32, the
    face path's within 10%, exact launches); then one request at 42 layers
    in setting (b) through the `InferenceServer` (`token_serving_request`);
    then each `TOKEN_ROWS` configuration once through its entry point
    against its plain version (one launch each).  `launches` takes the
    kernels line's token rows: each row's entry-point launch, and setting
    (b)'s B3 launches (forward + micro-batch) for "B3 K64 I5".  The
    settings' cases are queued on `refs`, as phase 3e's; the request and
    the entry points run at once."""
    import torch
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv

    def start(tag, ids, k_f, k_a):
        print(f"  phase 3i setting ({tag}): I = {ids}, K_f = {k_f}, K_a = {k_a}", flush=True)
        fwd, train, verdict = _dit_head_case(48, 64, face=True, ids=ids, face_tokens=k_f,
                                             audio_tokens=k_a)
        if (k_a, ids) == (64, 5):
            launches["B3 K64 I5"] = launches.get("B3 K64 I5", 0) + fwd["B3"] + train["B3"]
        return _verdict_ok(verdict)

    for setting in TOKEN_SETTINGS:
        refs.add(lambda setting=setting: start(*setting))
    ok = token_serving_request(args)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(98)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    calls = []
    for row, kernel, kk, ids in TOKEN_ROWS:
        if kernel == "B3":
            fn, what, sc = "short_kv_attention_combined_flat", "[26,1350,3072] 48x64", 0.125
            args_ = (rnd(26, 1350, 3072), rnd(26, ids, 48, kk, 64), rnd(26, ids, 48, kk, 64),
                     torch.rand((26, 1350, ids), generator=gen, device=dev).to(torch.bfloat16))
        else:
            fn, what, sc = "short_kv_attention_flat", "[2,17550,2048] 16x128", 128 ** -0.5
            args_ = (rnd(2, 17550, 2048), rnd(2, ids, 16, kk, 128), rnd(2, ids, 16, kk, 128))
        calls.append((row, f"{fn} {what} K={kk} I={ids}",
                      lambda fn=fn, a=args_, sc=sc: getattr(skv, fn)(*a, sc),
                      lambda fn=fn, a=args_, sc=sc: getattr(skv, f"{fn}_plain")(*a, sc)))
    return ok & _entry_calls(calls, launches)


def token_serving_request(args) -> bool:
    """Phase 3i's request (`_model_request`): 48 x 64 heads in setting (b)
    of `TOKEN_SETTINGS` (5 identities, 56 face and 64 audio tokens an
    identity: B2 and B3 on their general key blocks, the multi-ID STAB on
    B5' at S = 5)."""
    _, ids, k_f, k_a = TOKEN_SETTINGS[1]
    return _model_request(args, f"tokens and identities, {args.request_layers}-layer request "
                          f"(phase 3i; 48 x 64 heads", 41, ids=ids, face_tokens=k_f,
                          audio_tokens=k_a, layers=args.request_layers)


# ROADMAP C5: the face path's kernels and the fp32 plain versions that
# `face_plain_phase` swaps in for them (inside `models/router.py`, their
# one caller; B5's swap takes B5' and the backward B8 with it)
FACE_SWAPS = {"B2": ("short_kv_attention_flat", "short_kv_attention_flat_plain"),
              "B4": ("pair_axis_attention", "pair_axis_attention_plain"),
              "B5": ("tiny_seq_attention", "tiny_seq_attention_plain")}


@contextlib.contextmanager
def _face_kernels_plain(names):
    """Within the block, `models/router.py` calls the plain versions of
    the kernels `names` (keys of `FACE_SWAPS`) on fp32 copies of their
    inputs, cast back to the input's type; autograd differentiates them."""
    from bindyouravatar_tpu_torch.models import router
    from bindyouravatar_tpu_torch.ops import packed_attention as pa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv

    kept = {}
    for name in names:
        attr, plain = FACE_SWAPS[name]
        fn = getattr(skv if name == "B2" else pa, plain)
        kept[attr] = getattr(router, attr)
        setattr(router, attr, lambda *a, fn=fn: fn(*(t.float() for t in a[:3]), *a[3:]).to(
            a[0].dtype))
    try:
        yield
    finally:
        for attr, fn in kept.items():
            setattr(router, attr, fn)


def face_plain_phase() -> bool:
    """ROADMAP C5 (`--face-plain`): phase 3g's 24 x 128 case and phase 12c
    at T = 13 and 25, the face path's gradient errors against the CPU's
    fp32 with its kernels (B2, B4, B5 with B5' and B8) as they are, with
    all of them swapped for their plain versions in fp32 on the card, and
    (3g and T = 13) with each swapped alone.  The swapped runs' launch
    counts are not those the checks want; the errors are printed."""
    print("C5: the face path's kernels B2, B4 and B5 (with B5' and B8) swapped for their plain "
          "versions in fp32 on the card, inside models/router.py; the swapped runs' launch "
          "checks do not apply", flush=True)
    worst = lambda e: max((v for k, v in e.items() if _face_path(k)), default=0.0)
    cases = (("3g 24x128", lambda: _dit_head_case(24, 128, face=True)[2]()[1], True),
             ("12c T=13", lambda: _long_clip_case(49, {})()[1], True),
             ("12c T=25", lambda: _long_clip_case(97, {})()[1], False))
    for what, run, each in cases:
        swaps = [()] + [tuple(FACE_SWAPS)] + ([(n,) for n in FACE_SWAPS] if each else [])
        for names in swaps:
            with _face_kernels_plain(names):
                errs = run()
            top = sorted(((k, v) for k, v in errs.items() if _face_path(k)),
                         key=lambda kv: -kv[1])[:3]
            print(f"C5 {what}, swapped: {'+'.join(names) or 'none'}: the face path's worst "
                  f"gradient error {worst(errs):.3e} ("
                  + " ".join(f"{k}={v:.3e}" for k, v in top) + ")", flush=True)
    return True


def _entry_calls(calls, launches: dict) -> bool:
    """Each (kernels line row, what, call, plain) of `calls` once, launches
    counted from 0: its output against its plain version, exactly one
    launch of the row's kernel and none other; `launches[row]` adds it."""
    import torch

    ok = True
    for row, what, call, plain in calls:
        torch.cuda.synchronize()
        _reset_launches()
        out = call()
        torch.cuda.synchronize()
        counts = _read_launches()
        name = row.split()[0]
        launches[row] = launches.get(row, 0) + counts[name]
        ref = plain()
        # tol: as phase 2 (bf16 roundings of the same fp32 values)
        err, _, match = _compare(out, ref, _rel_compare(out, ref, 2e-2), 2e-2)
        one = counts[name] == 1 and sum(counts.values()) == 1
        ok &= match and one
        print(f"entry point {what}: max_abs_err={err:.3e}, launches {name}={counts[name]} "
              f"(want 1, no other) {'ok' if match and one else 'FAILED'}", flush=True)
        del out, ref
    return ok


def width_entry_phase(launches: dict) -> bool:
    """Phase 3h: the short-KV and packed entry points at the widths no model
    of the smoke reaches, once each, launches counted from 0 a call:
    `short_kv_attention_flat` (B2) at 16 x 48 and 8 x 256 heads on the
    perceiver's 17,550 queries, `short_kv_attention_combined_qmajor` (B14)
    and `short_kv_attention_combined` (B2c) at 64 x 48 and 12 x 256 on the
    audio geometry, `short_kv_attention` (B2h) at 16 x 48 and 8 x 256;
    `tiny_seq_attention` at 8 x 48 heads ([5400, 13, 384]) forward and,
    under grad, backward (B5, B8), at S = 3 (B5') as 16 x 32, 8 x 48 and 4 x
    128 heads; `pair_axis_attention` (B4) at C = 384.  Outputs against the
    plain versions (phase 2's tolerances: 2% of the largest magnitude),
    gradients against the plain backward.  Fills `launches` with each
    row's launches."""
    import torch
    from bindyouravatar_tpu_torch.ops import packed_attention as pa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(97)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    wts = lambda *shape: torch.rand(shape, generator=gen, device=dev).to(torch.bfloat16)
    calls = []
    for d, h_p, h_a in ((48, 16, 64), (256, 8, 12)):
        kv_p, kv_a = [rnd(2, 2, h_p, 32, d) for _ in range(2)], [rnd(26, 2, h_a, 32, d)
                                                                 for _ in range(2)]
        q_f, q_h, w = rnd(2, 17550, h_p * d), rnd(2, h_p, 17550, d), wts(26, 1350, 2)
        q_q, q_ha = rnd(26, 1350, h_a, d), rnd(26, h_a, 1350, d)
        sc = d ** -0.5
        for row, fn, args in ((f"B2 dh{d}", "short_kv_attention_flat", (q_f, *kv_p)),
                              (f"B14 dh{d}", "short_kv_attention_combined_qmajor",
                               (q_q, *kv_a, w)),
                              (f"B2c dh{d}", "short_kv_attention_combined", (q_ha, *kv_a, w)),
                              (f"B2h dh{d}", "short_kv_attention", (q_h, *kv_p))):
            calls.append((row, f"{fn} {list(args[0].shape)}",
                          lambda fn=fn, args=args, sc=sc: getattr(skv, fn)(*args, sc),
                          lambda fn=fn, args=args, sc=sc: getattr(skv, f"{fn}_plain")(*args, sc)))
    for d, h in ((32, 16), (48, 8), (128, 4)):
        qkv = [rnd(5400, 3, h * d) for _ in range(3)]
        calls.append((f"B5' dh{d}", f"tiny_seq_attention [5400,3,{h * d}] {h}x{d}",
                      lambda qkv=qkv, h=h, d=d: pa.tiny_seq_attention(*qkv, h, d ** -0.5),
                      lambda qkv=qkv, h=h, d=d: pa.tiny_seq_attention_plain(*qkv, h, d ** -0.5)))
    qkv = [rnd(2, 2, 17550, 384) for _ in range(3)]
    calls.append(("B4 C384", "pair_axis_attention [2,2,17550,384] 8x48",
                  lambda: pa.pair_axis_attention(*qkv, 8, 48 ** -0.5),
                  lambda: pa.pair_axis_attention_plain(*qkv, 8, 48 ** -0.5)))
    ok = _entry_calls(calls, launches)
    # B5 and its backward B8 at 8 x 48 heads under autograd
    q, k, v, g = (rnd(5400, 13, 384) for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    _reset_launches()
    out = pa.tiny_seq_attention(*leaves, 8, 48 ** -0.5)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    counts = _read_launches()
    launches["B5 dh48"], launches["B8 dh48"] = counts["B5"], counts["B8"]
    want = [pa.tiny_seq_attention_plain(q, k, v, 8, 48 ** -0.5),
            *pa.tiny_seq_attention_bwd_plain(q, k, v, g, 8, 48 ** -0.5)]
    errs, match = [], True
    for got, ref in zip((out.detach(), *grads), want):
        err, _, m = _compare(got, ref, _rel_compare(got, ref, 2e-2), 2e-2)
        errs.append(err)
        match &= m
    one = counts["B5"] == 1 and counts["B8"] == 1 and sum(counts.values()) == 2
    ok &= match and one
    print("entry point tiny_seq_attention [5400,13,384] 8x48 under grad: max_abs_err "
          + " ".join(f"{e:.3e}" for e in errs) + f" (output, dq, dk, dv), launches "
          f"B5={counts['B5']} B8={counts['B8']} (want 1, 1) {'ok' if match and one else 'FAILED'}",
          flush=True)
    return ok


def _serving_model(args, steps: int, heads: int = 48, ids: int = 2,
                   face_tokens: int | None = None, audio_tokens: int | None = None,
                   layers: int = 42):
    """The 5B DiT (`layers` layers, face + audio; `heads` heads of 3072 / `heads`,
    its audio layers' derived from them; `ids` identities, `face_tokens` /
    `audio_tokens` tokens an identity where given, else the 5B's 32) and
    the VAE with bf16 weights drawn on the card from `--seed`, in a pipeline
    of `steps` denoise steps (DPM++, guidance 6, 49 x 480 x 720)."""
    import torch
    from bindyouravatar_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.models.vae import CausalVAE
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline

    dev = torch.device("cuda")
    bf = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(args.seed)
    cfg = DiTConfig(is_train_face=True, is_train_audio=True, dtype=bf, param_dtype=bf,
                    num_layers=layers, num_attention_heads=heads,
                    attention_head_dim=3072 // heads, num_ids=ids,
                    **({} if face_tokens is None else {"lfe_num_tokens": face_tokens}))
    audio = None if audio_tokens is None else dataclasses.replace(
        DiT.create(cfg, device="meta").audio_cfg, context_tokens=audio_tokens)
    dit = DiT.create(cfg, audio, device=dev, generator=gen)
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
        audio_embeds=f32(1, c.num_ids, n_af, a.blocks, a.audio_dim), seed=seed, request_id=rid,
        **cond, **kw)


def _serving_want(dit, fwd_face: int, fwd_audio: int, preps: int,
                  frame_tokens: int = 1350) -> dict:
    """Each kernel's launches over `fwd_face` face + audio and `fwd_audio`
    audio-only CFG forwards (batch-2 CFG: one a step, whatever the batch)
    and `preps` once-per-clip conditioning preps, at `frame_tokens` tokens
    a latent frame (30 x 45 at 480 x 720).  A face + audio forward runs B1
    42 (blocks) + 4 per face layer (STAB spatial, at >= 1,024 tokens a
    frame and a STAB head dim that is a multiple of 64:
    `models/router.py:SelfAttention`), B2 1
    and B4, B5
    4 per face layer (past 2 identities B5' or B5 for B4:
    `_multi_id_launches`), B3 42, B6 42 (audio norm_q) + 21 per face layer;
    an audio-only one B1 = B3 = B6 = 42; a prep one AudioProjModel B6."""
    c, a = dit.cfg, dit.audio_cfg
    n_ca, n_st = c.num_ca, dit.router_cfg.num_attention_layers
    face_b6 = 2 + 2 + 1 + 4 * n_st                 # perceiver, router norms, trunk, STABs
    stabs = n_ca * n_st * fwd_face
    r = dit.router_cfg
    flash = frame_tokens >= 1024 and (r.feat_dim // r.attn_heads) % 64 == 0  # spatial B1
    return {"B1": c.num_layers * (fwd_face + fwd_audio) + (stabs if flash else 0),
            "B2": n_ca * fwd_face, "B3": a.num_layers * (fwd_face + fwd_audio),
            **_multi_id_launches(c.num_ids, stabs, stabs, 0),
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


def serving_phase(args, long_launches: dict) -> bool:
    """Phase 4 on one fully conditioned DiT at the 5B geometry, each run's
    launch counts exact: `--requests` face + audio requests and 1
    audio-only request through the port's InferenceServer (whole decode);
    a request streamed in chunks of 4 latent frames against
    `decode(temporal_chunk=4)` of its latents, and the whole decode's and
    the chunked decode's seconds and peak; a forced-routing request against
    a direct `generate(routing_forcing=..., return_routing=True)` (bit for
    bit; the routing [steps, 21, 1, 17550, 2] bf16); one request through
    `serve_http` on 127.0.0.1; two co-batchable requests on a server with
    `batch_max=2`: one denoise, batch size 2.  Then phases 12a and 12d on
    the same model (`long_clip_server_phase`, their launches into
    `long_launches["12a"]` and `["12d"]`)."""
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
    return ok & long_clip_requests(args, pipe, long_launches)


def long_clip_requests(args, pipe, long_launches: dict) -> bool:
    """Phases 12a (97 x 480 x 720, streamed in chunks of 4 latent frames)
    and 12d (801 x 128 x 192, T = 201: B5 on the streamed body; whole
    decode) on `pipe`'s model, their launches into `long_launches["12a"]`
    and `["12d"]`."""
    long_launches["12a"], long_launches["12d"] = {}, {}
    ok = long_clip_server_phase(args, pipe, long_launches["12a"], "12a", 97, stream_chunk=4)
    return ok & long_clip_server_phase(args, pipe, long_launches["12d"], "12d", 801,
                                       size=(128, 192))


def clip_phase(args, launches: dict) -> bool:
    """Phase 7: one face + audio request through the InferenceServer at
    `--clip-steps` denoise steps (10; a shipped clip takes 50) on the 42-layer 5B model,
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


# ------------------------------------------------------------------ #
# reference-format files of drawn weights (phase 7e's scaffolding; the CPU
# tests hold export-then-read as the identity): the inverse of the port's
# readers, written from the reference's names and layouts
# ------------------------------------------------------------------ #

def _dit_rope_index(heads: int, head_dim: int):
    """For each interleaved (reference) q/k channel, the port's rotate-half
    channel: within a head, pair member 2j sits at j, 2j + 1 at hd/2 + j."""
    import torch

    r = torch.arange(head_dim)
    local = torch.where(r % 2 == 0, r // 2, head_dim // 2 + r // 2)
    return torch.cat([local + h * head_dim for h in range(heads)]), local


def export_reference_dit(named: dict, cfg) -> dict:
    """The DiT's base transformer (port names) -> a reference
    `BindyouravatarTransformer3DModel` state dict."""
    import re

    full, local = _dit_rope_index(cfg.num_attention_heads, cfg.attention_head_dim)
    groups = ("audio_statics.", "audio_layers.", "lfe.", "perceivers.", "router_norms.",
              "router_layers.", "router_trunk.")
    out = {}
    for name, t in named.items():
        if name.startswith(groups) or "_lora_" in name:
            continue
        if name == "patch_embed.proj.weight":
            p = cfg.patch_size
            t = t.reshape(t.shape[0], -1, p, p)
        elif re.search(r"attn1\.to_[qk]\.", name):
            t = t[full]
        elif re.search(r"attn1\.norm_[qk]\.", name):
            t = t[local]
        name = re.sub(r"^blocks\.", "transformer_blocks.", name)
        name = (name.replace(".attn1.to_out.", ".attn1.to_out.0.")
                .replace(".ff.net_0.", ".ff.net.0.proj.").replace(".ff.net_2.", ".ff.net.2."))
        out[name] = t
    return out


def export_reference_submodules(named: dict, router_heads: int) -> dict:
    """The conditioning modules (port names) -> the reference's
    `audio_modules.pt`, `face_modules.pt` and `router_modules.pt` objects:
    the audio Conv1d as [C, C, 2], each perceiver's `to_kv` fused, the
    router's q/k features d-major (f = d*H + h)."""
    import re

    import torch

    audio, lfe, router, pcas = {}, {}, {}, {}
    for name, t in named.items():
        if name.startswith("audio_statics.proj.conv."):
            leaf = name.rsplit(".", 1)[1]
            if leaf == "weight":
                c = t.shape[0]
                t = torch.stack([t[:, :c], t[:, c:]], dim=-1)
            audio[f"audio_proj_model.conv1.{leaf}"] = t
        elif name.startswith("audio_statics.proj."):
            audio[name.replace("audio_statics.proj.", "audio_proj_model.")] = t
        elif name.startswith("audio_statics."):
            audio[name[len("audio_statics."):]] = t
        elif name.startswith("audio_layers."):
            n = re.sub(r"^audio_layers\.(\d+)\.to_out\.", r"layers.\1.attn.to_out.0.", name)
            n = re.sub(r"^audio_layers\.(\d+)\.(to_[qkv])\.", r"layers.\1.attn.\2.", n)
            audio[re.sub(r"^audio_layers\.", "layers.", n)] = t
        elif name.startswith("lfe."):
            n = name[len("lfe."):]
            for mine, idx in (("fc0", 0), ("ln0", 1), ("fc1", 3), ("ln1", 4), ("fc_out", 6)):
                n = re.sub(rf"^((?:id_embedding_)?mapping(?:_\d)?)\.{mine}\.", rf"\1.{idx}.", n)
            n = re.sub(r"^attn_(\d+)\.", r"layers.\1.0.", n)
            for mine, idx in (("norm", 0), ("fc1", 1), ("fc2", 3)):
                n = re.sub(rf"^ff_(\d+)\.{mine}\.", rf"layers.\1.1.{idx}.", n)
            lfe[n] = t
        elif name.startswith("perceivers."):
            _, j, rest = name.split(".", 2)
            pcas.setdefault(int(j), {})[rest] = t
        elif name.startswith(("router_norms.", "router_layers.", "router_trunk.")):
            router[name] = t
    qk = router["router_norms.norm_q.weight"].shape[0]
    dh = qk // router_heads
    f = torch.arange(qk)
    to_port = (f % router_heads) * dh + f // router_heads     # d-major f -> h-major
    rout = {}
    for name, t in router.items():
        m = re.match(r"^router_layers\.(\d+)\.(to_[qk])\.weight$", name)
        if m:
            rout[f"{m.group(2)}.{m.group(1)}.weight"] = t[:, to_port]
        elif name.startswith("router_norms."):
            rout[name[len("router_norms."):]] = t[to_port]
        else:
            n = name[len("router_trunk."):]
            n = re.sub(r"^st_(\d+)\.", r"spatial_temporal_layers.\1.", n)
            n = (n.replace(".to_out.", ".to_out.0.").replace(".mlp_fc1.", ".mlp.0.")
                 .replace(".mlp_fc2.", ".mlp.2."))
            rout[re.sub(r"^final_proj\.", "final_proj.0.", n)] = t
    perceivers = []
    for j in sorted(pcas):
        sd = dict(pcas[j])
        sd["to_kv.weight"] = torch.cat([sd.pop("to_k.weight"), sd.pop("to_v.weight")])
        perceivers.append(sd)
    return {"audio": audio, "face": {"local_facial_extractor": lfe,
                                     "perceiver_cross_attention": perceivers},
            "router": rout}


def export_vae(named: dict, cfg) -> dict:
    """The VAE (port names) -> a diffusers `AutoencoderKLCogVideoX` state
    dict: the down / upsamplers' convs lose their temporal axis."""
    from bindyouravatar_tpu_torch.training.import_encoders import vae_key_map

    return {theirs: named[ours][:, :, 0] if kind == "conv2d" else named[ours]
            for theirs, (ours, kind) in vae_key_map(cfg).items()}


def draw_peft_lora(cfg, rank: int, gen, dtype, std: float = 0.02) -> dict:
    """A peft LoRA file's tensors for every layer's q and k, named as the
    reference saves them (`transformer.transformer_blocks.{i}.attn1.to_q.
    lora_A.weight` [r, in], `lora_B` [out, r]), drawn on the CPU."""
    import torch

    inner = cfg.num_attention_heads * cfg.attention_head_dim
    out = {}
    for i in range(cfg.num_layers):
        for proj in ("to_q", "to_k"):
            base = f"transformer.transformer_blocks.{i}.attn1.{proj}"
            for leaf, shape in (("lora_A", (rank, inner)), ("lora_B", (inner, rank))):
                out[f"{base}.{leaf}.weight"] = (torch.randn(shape, generator=gen) * std).to(dtype)
    return out


def write_reference_files(named: dict, dit_cfg, router_heads: int, directory: str,
                          shards: int = 2) -> dict:
    """Write the DiT's tensors (port names, on the CPU) as the reference
    ships them into `directory`: the base transformer as `shards`
    safetensors shards (`diffusion_pytorch_model-0000k-of-0000n`) and the
    three sub-module `.pt` files.  Returns the paths and the bytes written."""
    import torch
    from bindyouravatar_tpu_torch.utils.safetensors import save_file

    base = export_reference_dit(named, dit_cfg)
    keys = list(base)
    paths, nbytes = {"transformer": []}, 0
    for k in range(shards):
        part = {n: base[n] for n in keys[k * len(keys) // shards:(k + 1) * len(keys) // shards]}
        path = os.path.join(directory,
                            f"diffusion_pytorch_model-{k + 1:05d}-of-{shards:05d}.safetensors")
        nbytes += save_file(part, path)
        paths["transformer"].append(path)
    for group, obj in export_reference_submodules(named, router_heads).items():
        path = paths[group] = os.path.join(directory, f"{group}_modules.pt")
        torch.save(obj, path)
        nbytes += os.path.getsize(path)
    paths["bytes"] = nbytes
    return paths


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


def _proc_io() -> dict:
    """This process's `/proc/self/io` counters (bytes written: `wchar`
    through write calls, `write_bytes` sent to the storage layer)."""
    with open("/proc/self/io") as f:
        return {k: int(v) for k, v in (line.split(":") for line in f)}


def _rss_gib(field: str) -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 2**20
    return float("nan")


class _RssPeak:
    """The largest `VmRSS` of this process seen while the `with` block runs
    (sampled every 20 ms on a thread: the kernel's own high-water mark
    cannot be reset without write access to `/proc/self/clear_refs`)."""

    def __enter__(self):
        import threading

        self.peak, self._stop = _rss_gib("VmRSS"), threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, _rss_gib("VmRSS"))

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, _rss_gib("VmRSS"))
        return False


def _reference_rows(heads: int, head_dim: int):
    """The reference's q/k row held by each of the port's rows (rotate-half
    row j < hd/2 of a head is interleaved row 2j, row hd/2 + j is 2j + 1)."""
    import torch

    c = torch.arange(head_dim)
    local = torch.where(c < head_dim // 2, 2 * c, 2 * (c - head_dim // 2) + 1)
    return torch.cat([local + h * head_dim for h in range(heads)])


def cli_reference_phase(args, peaks: dict) -> bool:
    """Phase 7e: the CLI's `run` from reference-format files.  The 42-layer
    5B DiT and VAE are drawn as 7c draws them, from another seed, cast as
    the CLI casts (bf16 DiT, fp32 VAE) and kept on the host; written as
    the reference ships them: the base transformer as bf16 safetensors in
    3 shards, `audio_modules.pt`, `face_modules.pt` (each perceiver's
    `to_kv` fused) and `router_modules.pt` (d-major q/k features) in bf16, a
    peft-named r128 q/k LoRA in bf16 and a diffusers-named VAE file
    (`write_reference_files`, `export_vae`).  `run` at 7c's inputs with
    `--reference_transformer`, the three `--reference_*_modules` flags and
    `--lora_path`, `--seed` the serving one; then: every DiT tensor equals
    the drawn one bit for bit, q/k equal the drawn + (B @ A)[rows] * alpha /
    r computed here in fp32 and cast; launches are 7c's; the clip equals
    `generate` on a pipeline built anew with those tensors copied in
    directly, bit for bit; `import_vae` of the VAE file gives the drawn
    VAE bit for bit.  Prints the bytes written, each group's read seconds,
    the peak device memory beside 7c's and the host's peak RSS."""
    import gc
    import shutil
    import tempfile
    import types

    import numpy as np
    import torch
    from bindyouravatar_tpu_torch import infer
    from bindyouravatar_tpu_torch.config import AudioConfig, DiTConfig, RouterConfig
    from bindyouravatar_tpu_torch.training.import_encoders import import_vae
    from bindyouravatar_tpu_torch.utils.safetensors import save_file

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    faces = [os.path.join(here, "assets", "faces", f"000_{i}.png") for i in (0, 1)]
    tmp = tempfile.mkdtemp(prefix="bya_reference_")
    rank, alpha = 128, 64.0     # alpha / r = 0.5: the scale shows, exact in fp32
    try:
        base = (_cli_inputs(tmp, args.seed + 200) + ["--img_file_path", *faces]
                + _face_checkpoints(tmp, args.seed))
        t0 = time.perf_counter()
        dargs = infer.get_args(base + ["--seed", str(args.seed + 700)])
        pipe = infer.build_models(dargs, dev)
        infer.load_params(pipe, dargs)
        named = {k: v.detach().cpu() for k, v in pipe.dit.state_dict().items()}
        vae_named = {k: v.detach().cpu() for k, v in pipe.vae.state_dict().items()}
        cfg, heads, vae_cfg = pipe.dit.cfg, pipe.dit.router_cfg.num_heads, pipe.vae.cfg
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        draw_s = time.perf_counter() - t0

        io0, t0 = _proc_io(), time.perf_counter()
        paths = write_reference_files(named, cfg, heads, tmp, shards=3)
        lora = draw_peft_lora(cfg, rank, torch.Generator().manual_seed(args.seed + 701),
                              torch.bfloat16)
        lora_path = os.path.join(tmp, "pytorch_lora_weights.safetensors")
        vae_path = os.path.join(tmp, "vae_diffusion_pytorch_model.safetensors")
        written = (paths["bytes"] + save_file(lora, lora_path)
                   + save_file(export_vae(vae_named, vae_cfg), vae_path))
        write_s, io1 = time.perf_counter() - t0, _proc_io()
        files = {"transformer": sum(os.path.getsize(f) for f in paths["transformer"]),
                 **{g: os.path.getsize(paths[g]) for g in ("audio", "face", "router")},
                 "lora": os.path.getsize(lora_path), "vae": os.path.getsize(vae_path)}

        argv = base + ["--seed", str(args.seed), "--reference_transformer",
                       *paths["transformer"], "--reference_audio_modules", paths["audio"],
                       "--reference_face_modules", paths["face"], "--reference_router_modules",
                       paths["router"], "--lora_path", lora_path, "--lora_alpha", str(alpha)]
        rss0 = _rss_gib("VmRSS")
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        with _RssPeak() as rss:
            res = infer.run(infer.get_args(argv))
            torch.cuda.synchronize()
        wall, counts = time.perf_counter() - t0, _read_launches()
        peak, rss_peak = torch.cuda.max_memory_allocated() / 2**30, rss.peak
        for f in paths["transformer"] + [paths[g] for g in ("audio", "face", "router")]:
            os.remove(f)
        os.remove(lora_path)

        # the loaded tensors against the drawn ones; q/k drawn + the LoRA delta
        prep = res.prep
        dit = prep.pipe.dit
        rows = _reference_rows(cfg.num_attention_heads, cfg.attention_head_dim).to(dev)
        want_dev, n_equal, bad = {}, 0, []
        live = dict(dit.named_parameters())
        for k, t in named.items():
            want = t.to(dev)
            if k.startswith("blocks.") and k.endswith((".to_q.weight", ".to_k.weight")):
                i, proj = int(k.split(".")[1]), k.split(".")[3]
                key = f"transformer.transformer_blocks.{i}.attn1.{proj}"
                a = lora[f"{key}.lora_A.weight"].to(dev, torch.float32)
                b = lora[f"{key}.lora_B.weight"].to(dev, torch.float32)
                want = (want.float() + (b @ a)[rows] * (alpha / rank)).to(t.dtype)
                want_dev[k] = want.cpu()
            if live[k].dtype == want.dtype and torch.equal(live[k], want):
                n_equal += 1
            else:
                bad.append(k)
        qk_moved = sum(not torch.equal(want_dev[k], named[k]) for k in want_dev)
        dit_ok = not bad and len(named) == len(live) and qk_moved == len(want_dev) == 84

        # the clip against generate on a pipeline built anew, tensors set directly
        video, load_s = res.video, dict(prep.load_seconds)
        prep.pipe = None
        del res, dit, live
        gc.collect()
        torch.cuda.empty_cache()
        plain = infer.get_args(base + ["--seed", str(args.seed)])
        pipe = infer.build_models(plain, dev)
        with torch.no_grad():
            for k, p in pipe.dit.named_parameters():
                p.copy_(want_dev.get(k, named[k]))
        infer.load_params(pipe, plain)                 # no file flags: the cast alone
        direct = pipe.generate(prep.pe, prep.ne, prep.image,
                               torch.Generator(dev).manual_seed(args.seed),
                               image_bg=prep.image_bg, **prep.cond)
        clip_ok = bool(np.array_equal(video, direct.float().cpu().numpy()))

        # the VAE file into the new pipeline's VAE (drawn from the serving seed)
        vae = pipe.vae
        differed = any(not torch.equal(p.cpu(), vae_named[k]) for k, p in vae.state_dict().items())
        t0 = time.perf_counter()
        import_vae(vae_path, vae)
        torch.cuda.synchronize()
        load_s["vae"] = time.perf_counter() - t0
        os.remove(vae_path)
        vae_ok = differed and all(torch.equal(p.cpu(), vae_named[k])
                                  for k, p in vae.state_dict().items())
        del pipe, vae, direct
    except Exception as e:
        import traceback

        traceback.print_exc()
        print(f"cli from reference files: FAILED with {type(e).__name__}: {e}", flush=True)
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    ok = _video_ok("CLI from reference files", video, (1, 49, 3, 480, 720))
    five_b = types.SimpleNamespace(cfg=DiTConfig(), audio_cfg=AudioConfig(),
                                   router_cfg=RouterConfig())
    ok &= _counts_ok("CLI from reference files (7c's)", counts, _serving_want(five_b, 2, 0, 1))
    ok &= dit_ok and clip_ok and vae_ok
    gb = lambda n: f"{n / 1e9:.3f} GB"
    print(f"cli from reference files: drawn (seed {args.seed + 700}) and moved to the host in "
          f"{draw_s:.1f} s; wrote {gb(written)} in {write_s:.1f} s ("
          + ", ".join(f"{g} {gb(n)}" for g, n in files.items())
          + f"; this process's wchar +{gb(io1['wchar'] - io0['wchar'])}, write_bytes "
          f"+{gb(io1['write_bytes'] - io0['write_bytes'])}, since it started wchar "
          f"{gb(io1['wchar'])}); run() in {wall:.1f} s, read and loaded: "
          + ", ".join(f"{g} {v:.2f} s" for g, v in load_s.items())
          + f"; DiT {n_equal}/{len(named)} tensors equal the drawn bit for bit (q/k: drawn + "
          f"LoRA r{rank} delta, {qk_moved} moved){'' if not bad else f' FAILED {bad[:4]}'}; "
          f"clip == generate with the tensors set directly bit for bit: {clip_ok}; VAE from its "
          f"file == drawn bit for bit: {vae_ok}; peak {peak:.2f} GiB against phase 7c's "
          f"{peaks.get('7c', float('nan')):.2f}; host RSS {rss0:.2f} GiB before run(), peak "
          f"{rss_peak:.2f} GiB during it {'ok' if ok else 'FAILED'}", flush=True)
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


def write_wav2vec2_dir(directory: str, layers: int, gen) -> None:
    """A wav2vec2-base HF directory (facebook/wav2vec2-base-960h's
    `config.json`, `layers` deep) with weights drawn from `gen`, written
    with the port's safetensors writer under HF's names, the positional
    kernel as weight-norm g / v (`parametrizations.weight.original0/1`)."""
    import torch
    from bindyouravatar_tpu_torch.preprocess.wav2vec2 import Wav2Vec2, Wav2Vec2Config
    from bindyouravatar_tpu_torch.utils.safetensors import save_file

    cfg = Wav2Vec2Config(num_hidden_layers=layers)
    model = Wav2Vec2(cfg)
    sd = {}
    with torch.no_grad():
        for k, p in model.state_dict().items():
            if k.endswith("layer_norm.weight"):
                t = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            elif p.ndim >= 2:
                t = torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5
            else:
                t = 0.02 * torch.randn(p.shape, generator=gen)
            sd[k] = t
    v = sd.pop("encoder.pos_conv_embed.conv.weight")
    sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"] = v
    sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"] = (
        v.square().sum(dim=(0, 1), keepdim=True).sqrt() * 1.1)
    os.makedirs(directory, exist_ok=True)
    hf = {f.name: getattr(cfg, f.name) for f in __import__("dataclasses").fields(cfg)}
    hf.update(architectures=["Wav2Vec2ForCTC"], model_type="wav2vec2")
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf, f)
    save_file(sd, os.path.join(directory, "model.safetensors"))


def wav2vec_phase(args) -> bool:
    """Phase 8, the audio encoder: wav2vec2-base at its published size
    (12 layers, 768 wide; weights drawn, written as an HF directory and
    read back through `preprocess/wav2vec2.load_wav2vec2`), fp32 with TF32
    off: `extract_wav2vec_embeddings` of 10 s of a synthetic 16 kHz wav to
    [250, 12, 768] at 25 fps, finite; the model's ms (CUDA events, median of
    3) and peak.  At 2 layers, the card against the CPU on the same files
    (relative L2 of the embeddings; tol 1e-4: fp32 on both sides, sums in
    another order).  It launches no kernel: JAX's wav2vec2 is transformers'."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile
    from bindyouravatar_tpu_torch.preprocess import audio, wav2vec2

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="bya_w2v_")
    try:
        gen = torch.Generator().manual_seed(args.seed + 500)
        t = np.arange(16000 * 10) / 16000
        rng = np.random.default_rng(args.seed + 500)
        sig = 0.3 * np.sin(2 * np.pi * 180 * t * (1 + 0.2 * np.sin(t))) + 0.05 * rng.normal(size=t.shape)
        wav = os.path.join(tmp, "speech.wav")
        wavfile.write(wav, 16000, (sig * 32767).astype(np.int16))
        full, two = os.path.join(tmp, "base"), os.path.join(tmp, "base2")
        write_wav2vec2_dir(full, 12, gen)
        write_wav2vec2_dir(two, 2, gen)
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        emb = audio.extract_wav2vec_embeddings(wav, 250, model_dir=full, device="cuda")
        first_s = time.perf_counter() - t0
        model = wav2vec2.load_wav2vec2(full, device="cuda")
        n_params = sum(p.numel() for p in model.parameters())
        x = torch.from_numpy(audio.read_wav_mono_16k(wav)).cuda()
        ms = _time_ms(lambda: wav2vec2.extract(model, x, 250), runs=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launched = sum(_read_launches().values())
        del model
        got = audio.extract_wav2vec_embeddings(wav, 250, model_dir=two, device="cuda")
        want = audio.extract_wav2vec_embeddings(wav, 250, model_dir=two, device="cpu")
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    finite = bool(np.isfinite(emb).all())
    ok = emb.shape == (250, 12, 768) and finite and rel <= 1e-4 and launched == 0
    print(f"wav2vec2-base ({n_params / 1e6:.1f}M params, 12 x 768, fp32, TF32 off) on 10 s at "
          f"16 kHz: embeddings {list(emb.shape)} finite={finite}, first call (read + extract) "
          f"{first_s:.2f} s, extract {ms:.3f} ms (CUDA events), peak {peak:.2f} GiB, kernel "
          f"launches {launched}; 2 layers cuda vs cpu relative L2 {rel:.2e} (tol 1e-4) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


def two_b_phase(args) -> bool:
    """Phase 10, the 2B variant at full width: CogVideoX-2B's published
    transformer widths (THUDM/CogVideoX-2b `transformer/config.json`: 30
    layers, 30 x 64 heads, dim 1920, text 4096, time embed 512, sincos
    positions, interpolation 1.875 / 1.0) with the 5B avatar layout (48
    input channels, a face layer every second block, audio in every block,
    the router and LFE as `DiT.create` derives them: q_k_dim 1280, 16
    router heads of 80), bf16 weights drawn on the card: one face + audio
    request of 2 DPM++ steps at 49 x 480 x 720 through `pipeline.generate`,
    decoded whole: finite [1, 49, 3, 480, 720], s a step, peak, exact
    launches (B1 with the fused QK-LN and no RoPE at 30 heads, B2 at 16 x 80
    heads padded to 128).  Then 2 layers at the same widths (3 latent
    frames, 16 x 24 latents) on the card in bf16 against the CPU in fp32 on
    the same weights: output relative L2 <= 2e-2, routing within 0.05."""
    import gc

    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.models.vae import CausalVAE
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline

    gc.collect()
    torch.cuda.empty_cache()
    dev, bf = torch.device("cuda"), torch.bfloat16
    two_b = dict(num_attention_heads=30, attention_head_dim=64, num_layers=30,
                 time_embed_dim=512, text_embed_dim=4096, use_rotary_positional_embeddings=False,
                 spatial_interpolation_scale=1.875, temporal_interpolation_scale=1.0)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(args.seed + 600)
    dit = DiT.create(DiTConfig(dtype=bf, param_dtype=bf, **two_b), device=dev, generator=gen)
    vae = CausalVAE.create(VAEConfig(param_dtype=bf), device=dev, generator=gen)
    pipe = BindYourAvatarPipeline.create(dit, vae, PipelineConfig(num_inference_steps=2))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    weights = torch.cuda.memory_allocated() / 2**30
    draw_s = time.perf_counter() - t0
    c, a, lf = dit.cfg, dit.audio_cfg, dit.lfe_cfg
    rng = np.random.default_rng(args.seed + 600)
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    n_af = 49 + a.window_size - a.window_stride
    pe = f(1, c.max_text_seq_length, c.text_embed_dim)
    image = torch.from_numpy(rng.uniform(-1, 1, (1, 1, 3, 480, 720)).astype(np.float32)).to(dev)
    cond = dict(id_cond=f(1, c.num_ids, lf.id_embed_dim),
                id_vit_hidden=f(1, c.num_ids, lf.num_scales, 577, lf.vit_dim),
                audio_embeds=f(1, 2, n_af, a.blocks, a.audio_dim))
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with torch.inference_mode():
        video = pipe.generate(pe, torch.zeros_like(pe), image,
                              torch.Generator(dev).manual_seed(args.seed), timings=timings,
                              **cond)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = _read_launches()
    want = _serving_want(dit, 2, 0, 1)
    v = video.float().cpu().numpy()
    ok = _video_ok("2b clip", v, (1, 49, 3, 480, 720))
    ok &= _counts_ok("2b clip", counts, want)
    print(f"2b model: DiT {n_params / 1e9:.3f}B params (30 layers, 30 x 64 heads, dim 1920, "
          f"pos_embedding {list(dit.pos_embedding.shape)}, router q_k_dim "
          f"{dit.router_cfg.q_k_dim} = 16 x {dit.perceivers[0].dim_head}), bf16 drawn in "
          f"{draw_s:.1f} s, weights {weights:.2f} GiB; 2 steps: encode "
          f"{timings['encode_s']:.2f} s, denoise {timings['denoise_s']:.2f} s "
          f"({timings['denoise_s'] / 2:.3f} s a step), decode {timings['decode_s']:.2f} s, peak "
          f"{peak:.2f} GiB", flush=True)
    del pipe, dit, vae, video
    gc.collect()
    torch.cuda.empty_cache()

    # 2 layers at the same widths: bf16 on the card against fp32 on the CPU
    small = dict(two_b, num_layers=2, sample_frames=9, sample_height=16, sample_width=24)
    ref = DiT.create(DiTConfig(dtype=torch.float32, param_dtype=torch.float32, **small),
                     device="cpu", generator=torch.Generator().manual_seed(args.seed + 601))
    gpu = DiT.create(DiTConfig(dtype=bf, param_dtype=torch.float32, fuse_qk_norm=True, **small),
                     device=dev)
    gpu.load_state_dict(ref.state_dict())
    ref.set_fuse_qk_norm(True)
    rc = ref.cfg
    n_af = rc.sample_frames + a.window_size - a.window_stride
    inputs = dict(latents=rng.normal(size=(2, rc.latent_frames, 48, 16, 24)),
                  text_embeds=rng.normal(size=(2, 226, 4096)), timesteps=np.array([999.0, 499.0]),
                  id_cond=rng.normal(size=(2, 2, lf.id_embed_dim)),
                  id_vit_hidden=rng.normal(size=(2, 2, lf.num_scales, 17, lf.vit_dim)),
                  audio_embeds=rng.normal(size=(2, 2, n_af, a.blocks, a.audio_dim)))
    outs = []
    with torch.inference_mode():
        for model, d in ((ref, "cpu"), (gpu, "cuda")):
            t = {k: torch.tensor(v, dtype=torch.float32, device=d) for k, v in inputs.items()}
            out, routing = model.apply(t.pop("latents"), t.pop("text_embeds"),
                                       t.pop("timesteps"), model.rope(128, 192, 3, device=d), **t)
            outs.append((out.float().cpu(), routing.float().cpu()))
    rel = float((outs[1][0] - outs[0][0]).norm() / outs[0][0].norm())
    r_err = float((outs[1][1] - outs[0][1]).abs().max())
    small_ok = rel <= 2e-2 and r_err <= 0.05 and bool(outs[1][0].isfinite().all())
    ok &= small_ok
    print(f"2b 2 layers (widths full, 226 + 288 tokens, face + audio): cuda-bf16 vs cpu-fp32 "
          f"output relative L2 {rel:.3e} (tol 2e-2), routing {list(outs[0][1].shape)} "
          f"max_abs_err {r_err:.3e} (tol 0.05) {'ok' if small_ok else 'FAILED'}", flush=True)
    del ref, gpu
    gc.collect()
    torch.cuda.empty_cache()
    print(f"2b phase {'ok' if ok else 'FAILED'}", flush=True)
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
    sums over its 32-, 16- or 8-bit words; wrap-around is deterministic)."""
    import torch

    w = t.detach().contiguous()
    w = w.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[w.element_size()]).long()
    return int(w.sum()), int((w * (w & 0xFFFF)).sum())


def train_phase(args, launches: dict, record: dict) -> bool:
    """`args.train_steps` optimizer steps of `Trainer.train_step` (2
    micro-batches each, batch 1 per micro-batch) on the repo's default
    configuration at full width: `DiTConfig(lora_rank=128, remat=True,
    remat_policy="nested")` (`--train-layers`: 4 of the 42 layers,
    dim 3072, 226 + 17,550 tokens, face + audio), fp32 weights drawn on the
    card from a seed, bf16 compute.  Checks finite loss and metrics, moved
    trainable and bit-identical frozen tensors, and each kernel's launch
    count; fills `launches`, and `record` with the step walls, the peak, the
    launches and the trainable tensors after the steps (on the host: phase
    11 holds its sharded step against them)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dit, tr, state, batch, gen_step = _stage3_setup(args)
    cfg = dit.cfg
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in tr.trainable.values())
    n_all = sum(p.numel() for p in dit.parameters())
    print(f"train model: DiT {n_all / 1e9:.3f}B params ({cfg.num_layers} layers"
          f"{'' if cfg.num_layers == 42 else ', depth cut from 42'}), trainable "
          f"{n_train / 1e9:.3f}B in {len(tr.trainable)} tensors, fp32 weights drawn on the card "
          f"with the AdamW state and the batch in {time.perf_counter() - t0:.1f} s; weights + "
          f"AdamW state "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    before_t = {k: _fingerprint(p) for k, p in tr.trainable.items()}
    before_f = {k: _fingerprint(p) for k, p in tr.frozen.items()}

    ok = True
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
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
        record.setdefault("step_s", []).append(wall)
        finite = all(math.isfinite(v) for v in vals.values())
        ok &= finite
        print(f"train step {i + 1}: {wall:.2f} s wall ({accum} micro-batches: {shown}; "
              f"lr {tr.lr(state.count - 1):.2e}); "
              + " ".join(f"{k}={v:.5g}" for k, v in vals.items())
              + f" finite={finite}", flush=True)
    torch.cuda.synchronize()
    launches.update(_read_launches())
    peak = torch.cuda.max_memory_allocated() / 2**30
    # phase 11 holds its sharded step against these trainable tensors
    record.update(peak_gib=peak, layers=cfg.num_layers, launches=dict(launches),
                  after={k: p.detach().to("cpu", copy=True) for k, p in tr.trainable.items()})

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
        no_grad = [k for k in still if not bool(state.opt["mu"][k].any())]
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
    ok &= save_attn_phase(args, tr, batch)
    del state          # AdamW's moments: phase 5c keeps its own optimizers' state
    return ok & optimizer_phase(args, tr, batch, record)


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


def _state_bytes(opt: dict) -> int:
    """Bytes of an optimizer's state (`TrainState.opt`)."""
    return sum(t.numel() * t.element_size() for part in opt.values() for t in part.values())


# phase 5c's optimizers (phase 11 runs each sharded)
OPTIMIZER_RUNS = {"adafactor": dict(optimizer="adafactor"),
                  "prodigy": dict(optimizer="prodigy", learning_rate=1.0),
                  "adamw 8-bit": dict(optimizer="adamw", use_8bit_adam=True)}

# phase 5c's CPU reference: whole stacked leaves (adafactor's block RMS spans
# the layers of one), factored ([3072, 128], [128, 3072], [2048, 2048]) and not
OPT_CHECK = (r"^blocks\.\d+\.attn1\.to_q_lora_A$", r"^blocks\.\d+\.attn1\.to_k_lora_B$",
             r"^perceivers\.\d+\.to_k\.weight$", r"^audio_layers\.\d+\.norm_q\.bias$",
             r"^router_trunk\.final_proj\.weight$")


def _prodigy_two_steps(dit, schedule, one, draw) -> bool:
    """Prodigy's d moves from its second step on (x0 - x is 0 at the first,
    so d_hat is 0 there): two steps on one micro-batch with the same draws,
    `OPT_CHECK`'s tensors the whole trainable set so that the CPU reference
    (fp32, the card's clipped gradients) sums d's numerator and the norm of
    s over the same group.  Each step's update within 1e-5 of the largest
    plus an fp32 spacing, d, d_max and d's numerator within 1e-5 relative
    of the CPU's, and d above d0 after step 2.  lr 10: with the same
    gradient twice, step 2's d_hat is about lr (1 - b1) / sqrt(1 - b2) /
    (1 + b3^(1/2)) d0, 0.22 lr d0 at b2 = 0.95, so at lr 1 d would stay d0
    for about five steps."""
    import gc

    import torch
    from bindyouravatar_tpu_torch.config import TrainConfig
    from bindyouravatar_tpu_torch.training.trainer import Trainer, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = TrainConfig(optimizer="prodigy", learning_rate=10.0, lr_scheduler="constant",
                      grad_accum_steps=1)
    tr = Trainer(dit, schedule, cfg, trainable_patterns=OPT_CHECK)
    state = tr.init_state()
    names, groups = list(tr.trainable), {"all": list(tr.trainable)}
    ref = make_optimizer(cfg)
    cpu_p = {k: p.detach().float().cpu().clone() for k, p in tr.trainable.items()}
    cpu_state = ref.init(cpu_p, groups)
    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    ok, lines = True, []
    for step in range(2):
        before = {k: tr.trainable[k].detach().float().cpu().clone() for k in names}
        cpu_before = {k: v.clone() for k, v in cpu_p.items()}
        grads, _ = tr.grads_and_metrics(one, [draw])
        state = tr.apply_gradients(state, grads)
        g_cpu = {k: grads[k].detach().float().cpu() for k in names}      # clipped in place
        del grads
        ref.step(cpu_p, g_cpu, cpu_state, groups, {"all": tr.lr(step)}, step)
        worst, largest = 0.0, 0.0
        for k in names:
            u_card = tr.trainable[k].detach().double().cpu() - before[k].double()
            u_cpu = cpu_p[k].double() - cpu_before[k].double()
            largest = max(largest, float(u_cpu.abs().max()))
            spacing = torch.finfo(torch.float32).eps * cpu_p[k].double().abs()
            worst = max(worst, float(((u_card - u_cpu).abs() - spacing).max()))
        d, d_max, num = (state.opt[kind]["all"] for kind in ("d", "d_max", "d_numerator"))
        d_ref, d_max_ref, num_ref = (cpu_state[kind]["all"]
                                     for kind in ("d", "d_max", "d_numerator"))
        step_ok = (worst <= 1e-5 * largest and largest > 0 and rel(d, d_ref) <= 1e-5
                   and rel(d_max, d_max_ref) <= 1e-5
                   and (step == 0 or (rel(num, num_ref) <= 1e-5 and float(d) > ref.d0)))
        ok &= step_ok
        lines.append(f"step {step + 1}: d {float(d):.6e} (cpu {float(d_ref):.6e}), d_max "
                     f"{float(d_max):.6e} (cpu {float(d_max_ref):.6e}), d's numerator {float(num):.6e} (cpu {float(num_ref):.6e}), update worst "
                     f"excess {worst:.3e} of largest {largest:.3e} "
                     f"{'ok' if step_ok else 'FAILED'}")
    print(f"optimizer prodigy, 2 steps on {len(names)} tensors ({dit.cfg.num_layers} layers, one "
          f"micro-batch, the same draws, lr 10; d0 {ref.d0:g}; tol 1e-5): " + "; ".join(lines)
          + f" {'ok' if ok else 'FAILED'}", flush=True)
    del tr, state
    return ok


def optimizer_phase(args, tr5, batch, record: dict) -> bool:
    """Phase 5c on phase 5's DiT (`--train-layers`, 4 by default, LoRA
    r128, "nested") and batch (2 micro-batches): one optimizer step each of
    adafactor (lr 1e-5), prodigy (lr 1.0) and 8-bit AdamW (lr 1e-5),
    constant schedules, each from phase 5's trainable tensors (`record`'s
    "after") and the same draws (`record["5c"]` keeps them, and each step's
    trainable tensors after it, on the host: phase 11 holds its sharded
    adafactor and 8-bit steps against them): the step's seconds, peak memory, the optimizer
    state's bytes and launches; each update on `OPT_CHECK`'s tensors against
    the same optimizer on the CPU in fp32 from the card's clipped gradients
    and the same start (every element within 1e-5 of the largest update
    plus an fp32 spacing of the parameter: the same fp32 math, sums in
    another order; prodigy's first step keeps d at d0, so its update needs
    no sum over the other tensors; `_prodigy_two_steps` checks d's growth).
    Then one micro-batch at `ff_chunks=4`
    beside `ff_chunks=1`: peak, seconds, and every trainable gradient within
    5% relative L2 of ff_chunks=1's (bf16 products: the chunked backward
    rounds its weight gradients once a chunk), key biases against their
    query biases' norms.  No checkpoint is written."""
    import dataclasses
    import gc
    import re

    import torch
    from bindyouravatar_tpu_torch.config import TrainConfig
    from bindyouravatar_tpu_torch.training.trainer import Trainer, make_optimizer

    dit, dev = tr5.dit, torch.device("cuda")
    accum = tr5.cfg.grad_accum_steps
    gen = torch.Generator(dev).manual_seed(args.seed + 400)
    draws = [tr5.draw({"video_latents": batch["video_latents"][j:j + 1]}, gen)
             for j in range(accum)]
    ok = True
    n_train = sum(p.numel() for p in tr5.trainable.values())
    record["5c"] = {"draws": draws}
    for name, kw in OPTIMIZER_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            for k, p in tr5.trainable.items():
                p.copy_(record["after"][k])
        cfg = TrainConfig(lr_scheduler="constant", **kw)
        tr = Trainer(dit, tr5.schedule, cfg)
        state = tr.init_state()
        state_b = _state_bytes(state.opt)
        names = [k for k in tr.trainable if any(re.match(r, k) for r in OPT_CHECK)]
        before = {k: tr.trainable[k].detach().float().cpu() for k in names}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        grads, metrics = tr.grads_and_metrics(batch, draws)
        state = tr.apply_gradients(state, grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = _read_launches()
        want = train_launches(dit, accum)
        after = {k: tr.trainable[k].detach().float().cpu() for k in names}
        g_cpu = {k: grads[k].detach().float().cpu() for k in names}      # clipped in place
        del grads
        ref = make_optimizer(cfg)
        groups = {"all": names}
        cpu_p = {k: v.clone() for k, v in before.items()}
        cpu_state = ref.init(cpu_p, groups)
        ref.step(cpu_p, g_cpu, cpu_state, groups, {"all": tr.lr(0)}, 0)
        worst, largest = 0.0, 0.0
        for k in names:
            u_card, u_cpu = after[k].double() - before[k].double(), cpu_p[k].double() - before[k].double()
            largest = max(largest, float(u_cpu.abs().max()))
            spacing = torch.finfo(torch.float32).eps * cpu_p[k].double().abs()
            worst = max(worst, float(((u_card - u_cpu).abs() - spacing).max()))
        upd_ok = worst <= 1e-5 * largest and largest > 0
        counts_ok = {k: counts[k] for k in want} == want
        finite = all(math.isfinite(float(v)) for v in metrics.values())
        step_ok = upd_ok and counts_ok and finite
        ok &= step_ok
        if name != "prodigy":
            record["5c"][name] = dict(step_s=[wall], peak_gib=peak, loss=float(metrics["loss"]),
                                      after={k: p.detach().to("cpu", copy=True)
                                             for k, p in tr.trainable.items()})
        print(f"optimizer {name} ({dit.cfg.num_layers} layers, {accum} micro-batches): step "
              f"{wall:.2f} s, peak {peak:.2f} GiB, state {state_b / 1e9:.3f} GB "
              f"({state_b / n_train:.2f} B a trainable parameter), loss "
              f"{float(metrics['loss']):.5g}; update of {len(names)} tensors against the CPU "
              f"(fp32): worst excess {worst:.3e} of largest update {largest:.3e} (tol 1e-5 of "
              f"it + an fp32 spacing) {'ok' if upd_ok else 'FAILED'}; launches "
              + " ".join(f"{k}={counts[k]} (want {want[k]})" for k in want if want[k] or counts[k])
              + f" {'ok' if step_ok else 'FAILED'}", flush=True)
        del tr, state
    one = {k: v if v is None or k == "mute_embeds" else v[:1] for k, v in batch.items()}
    ok &= _prodigy_two_steps(dit, tr5.schedule, one, draws[0])
    # ff_chunks: one micro-batch (the first), the same draws, chunks 1 then 4
    tr = Trainer(dit, tr5.schedule, TrainConfig(grad_accum_steps=1))
    tr.init_state()
    runs = {}
    for chunks in (1, 4):
        dit.cfg = dataclasses.replace(dit.cfg, ff_chunks=chunks)
        for blk in dit.blocks:
            blk.ff.chunks = chunks
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        grads, metrics = tr.grads_and_metrics(one, draws[:1])
        torch.cuda.synchronize()
        runs[chunks] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30,
                        _read_launches(), float(metrics["loss"]),
                        {k: g.detach().float().cpu() for k, g in grads.items()})
        del grads
    dit.cfg = dataclasses.replace(dit.cfg, ff_chunks=1)
    for blk in dit.blocks:
        blk.ff.chunks = 1
    (w1, p1, c1, l1, g1), (w4, p4, c4, l4, g4) = runs[1], runs[4]

    def rel_l2(k):
        ref = g1[k.replace("_k.bias", "_q.bias")] if k.endswith("to_k.bias") else g1[k]
        d = float((g4[k] - g1[k]).norm())
        return d / float(ref.norm()) if float(ref.norm()) > 0 else d

    rel = {k: rel_l2(k) for k in g1}
    worst = sorted(rel, key=rel.get)[-3:][::-1]
    want = train_launches(dit, 1)
    ff_ok = (rel[worst[0]] <= 0.05 and abs(l4 - l1) <= 1e-2 * abs(l1)
             and {k: c4[k] for k in want} == want == {k: c1[k] for k in want})
    ok &= ff_ok
    print(f"ff_chunks=4 vs 1 (one micro-batch, {dit.cfg.num_layers} layers): "
          f"{w4:.2f} s vs {w1:.2f} s, peak {p4:.2f} GiB vs {p1:.2f} GiB, loss {l4:.6g} vs "
          f"{l1:.6g}; {len(rel)} trainable gradients, worst relative L2 "
          + " ".join(f"{k}={rel[k]:.3e}" for k in worst)
          + f" (tol 0.05); launches equal to train_launches {'ok' if ff_ok else 'FAILED'}",
          flush=True)
    return ok


def write_index_fixture(directory: str, seed: int, samples: int = 2, frames: int = 49,
                        height: int = 480, width: int = 720) -> str:
    """An `AvatarVideoDataset` index under `directory` (the reference's
    `video_root,anno_json,anno_base` rows): per sample an mp4 written with
    `cv2.VideoWriter` (two discs on a moving gradient), the left / right
    identities' PNG masks for every frame, two audio `.pt` tracks [frames +
    4, 12, 768] and the JSON annotation (caption, bboxes, tracks, speaker).
    Returns the index's path."""
    import cv2
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    videos = os.path.join(directory, "videos")
    os.makedirs(videos, exist_ok=True)
    yy, xx = np.mgrid[0:height, 0:width]
    rows = []
    for j in range(samples):
        base = os.path.join(directory, f"anno{j}")
        path = os.path.join(videos, f"clip{j}.mp4")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (width, height))
        centres = [(width // 4, height // 2), (3 * width // 4, height // 2)]
        for f in range(frames):
            img = np.stack([(xx // 3 + 4 * f) % 256, (yy // 2 + 2 * f + 40 * j) % 256,
                            np.full_like(xx, 90)], -1).astype(np.uint8)
            for i, (cx, cy) in enumerate(centres):
                disc = (xx - cx - 2 * f) ** 2 + (yy - cy) ** 2 < (height // 5) ** 2
                img[disc] = (230, 200 - 60 * i, 160)
                mdir = os.path.join(base, str(i + 1))
                os.makedirs(mdir, exist_ok=True)
                cv2.imwrite(os.path.join(mdir, f"{f:05d}.png"), disc.astype(np.uint8) * 255)
            wr.write(img)
        wr.release()
        tracks = []
        for t in range(2):
            tracks.append(os.path.join(base, f"audio{t}.pt"))
            torch.save(torch.from_numpy(rng.standard_normal((frames + 4, 12, 768))
                                        .astype(np.float32)), tracks[-1])
        r = height // 5
        anno = {"video": f"clip{j}.mp4", "caption": f"two people talking, clip {j}",
                "audio_emb": tracks, "speaker_left": j == 0,
                "bboxes": {str(i + 1): [cx - r, cy - r, cx + r, cy + r]
                           for i, (cx, cy) in enumerate(centres)}}
        with open(os.path.join(directory, f"anno{j}.json"), "w") as fh:
            json.dump(anno, fh)
        rows.append(f"{videos},{os.path.join(directory, f'anno{j}.json')},{base}")
    index = os.path.join(directory, "index.txt")
    with open(index, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return index


def driver_phase(args) -> bool:
    """Phase 6: `training.sft.main` at `--model_size 5b` (`--driver-layers`
    deep, widths full) on the on-disk dataset (`--index_file`: 2 samples of
    49 x 480 x 720 that `write_index_fixture` writes), with 8-bit AdamW
    (`--use_8bit_adam`) and a validation video of 2 steps at every
    checkpoint (`--num_validation_videos 1 --validation_steps 2`): 2 steps
    and a checkpoint, then a resumed run to step 3; checks the restore (the
    trainable tensors and every kind of optimizer state, bit for bit), the
    rows of `metrics.jsonl`, the frozen tensors, the validation mp4s and each
    run's launch counts against `train_launches` plus the validation's B1."""
    import gc
    import shutil
    import tempfile
    import traceback

    import torch
    from bindyouravatar_tpu_torch.training import sft

    gc.collect()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="bya_sft_")
    data_dir = tempfile.mkdtemp(prefix="bya_data_")
    t0 = time.perf_counter()
    index = write_index_fixture(data_dir, args.seed)
    fixture_s = time.perf_counter() - t0
    argv = ["--model_size", "5b", "--output_dir", out, "--checkpointing_steps", "2",
            "--checkpoints_total_limit", "1", "--remat_policy", "nested",
            "--seed", str(args.seed), "--num_layers", str(args.driver_layers),
            "--index_file", index, "--use_8bit_adam", "--num_validation_videos", "1",
            "--validation_steps", "2"]

    def digest(driver, state):
        tr = driver.trainer
        host = driver.host_state()
        return dict(params={k: _fingerprint(p) for k, p in tr.trainable.items()},
                    opt={kind: {k: _fingerprint(t) for k, t in part.items()}
                         for kind, part in state.opt.items()},
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
        # each run validates once (a checkpoint at step 2, then at the end,
        # step 3): 2 unconditioned CFG forwards, B1 in every block
        for want in (want1, want2):
            want["B1"] += 2 * dit.cfg.num_layers
        n_layers = dit.cfg.num_layers
        kinds = sorted(first.state.opt)
        state_b = _state_bytes(first.state.opt)
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
        videos = {s: os.path.getsize(os.path.join(out, f"validation-{s}", "video_0.mp4"))
                  for s in (2, 3) if os.path.isfile(os.path.join(out, f"validation-{s}",
                                                                 "video_0.mp4"))}
        free = shutil.disk_usage(out).free
    except Exception as e:
        traceback.print_exc()
        print(f"driver (sft 5b): FAILED with {type(e).__name__}: {e}", flush=True)
        return False
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(data_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    same = {k: restored.get(k) == saved[k]
            for k in ("params", "opt", "sampler", "np_rng", "torch_rng", "step")}
    rows_ok = ([r["step"] for r in rows] == [1, 2, 3]
               and all(math.isfinite(v) for r in rows for v in r.values()))
    frozen_ok = final["frozen"] == saved["frozen"]
    counts_ok = ({k: counts1[k] for k in want1} == want1
                 and {k: counts2[k] for k in want2} == want2)
    videos_ok = sorted(videos) == [2, 3] and all(v > 0 for v in videos.values())
    ok = (all(same.values()) and final["step"] == 3 and rows_ok and frozen_ok and counts_ok
          and videos_ok and kinds == ["qm", "qv", "sm", "sv"])
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
          f"{accum} micro-batches a step, --index_file of 2 samples written in {fixture_s:.1f} s, "
          f"8-bit AdamW state {kinds} {state_b / 1e9:.3f} GB, validation mp4s "
          f"{ {s: v for s, v in videos.items()} } bytes): run 1 (2 steps) {wall1:.1f} s, run 2 "
          f"(restore + step 3) {wall2:.1f} s; {left:.2f} GiB left between runs; restored == saved "
          + " ".join(f"{k}={v}" for k, v in same.items())
          + f"; final step {final['step']}; metrics rows {len(rows)} finite={rows_ok}; frozen "
          f"{len(saved['frozen'])} tensors bit-identical={frozen_ok}; free disk "
          f"{free / 1e9:.1f} GB; launches run 1 "
          + " ".join(f"{k}={counts1[k]} (want {want1[k]})" for k in want1)
          + "; run 2 " + " ".join(f"{k}={counts2[k]} (want {want2[k]})" for k in want2)
          + f" {'ok' if ok else 'FAILED'}", flush=True)
    return ok


# ------------------------------------------------------------------ #
# phase 12: long clips, 81 and 97 frames (T = 21 and 25 latent frames: the
# router's temporal STAB attention on B5's and B8's long body)
# ------------------------------------------------------------------ #

@contextlib.contextmanager
def _watch_tiny_seq():
    """While open, count each (body, S, fwd / bwd) that the tiny-sequence
    wrappers dispatch on the card (`packed_attention.kernel_body`) and
    every call of their plain versions (a run on the card makes none), in
    every thread (a server's worker, autograd's device thread) but the
    `_References` worker, whose CPU references call the plain versions
    meanwhile."""
    from collections import Counter

    from bindyouravatar_tpu_torch.ops import packed_attention as pa

    seen = {"bodies": Counter(), "plain": 0}
    plains = ("tiny_seq_attention_plain", "packed_head_attention_plain",
              "tiny_seq_attention_bwd_plain")
    saved = {n: getattr(pa, n) for n in plains + ("kernel_body",)}
    counts = lambda: not getattr(_REFERENCE_THREAD, "on", False)

    def body(s, width, heads, backward=False):
        name = saved["kernel_body"](s, width, heads, backward)
        if counts():
            seen["bodies"][(name, s, "bwd" if backward else "fwd")] += 1
        return name

    def counted(fn):
        def call(*a, **kw):
            if counts():
                seen["plain"] += 1
            return fn(*a, **kw)
        return call

    pa.kernel_body = body
    for n in plains:
        setattr(pa, n, counted(saved[n]))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(pa, n, fn)


def _bodies_ok(what: str, seen: dict, want: set) -> bool:
    """The dispatched (body, S, direction)s are `want` and no plain version ran."""
    ok = set(seen["bodies"]) == want and seen["plain"] == 0
    got = " ".join(f"{b} S={s} {d} x{n}" for (b, s, d), n in sorted(seen["bodies"].items()))
    print(f"  {what} tiny-sequence dispatch: {got or 'none'} (want "
          + " ".join(f"{b} S={s} {d}" for b, s, d in sorted(want))
          + f"), plain versions called {seen['plain']} times {'ok' if ok else 'FAILED'}",
          flush=True)
    return ok


def long_clip_server_phase(args, pipe, launches: dict, phase: str, frames: int,
                           size=None, stream_chunk=None) -> bool:
    """Phase 12a or 12d on phase 4's model (the 42-layer face + audio 5B,
    bf16 weights drawn on the card): one face + audio request through the
    `InferenceServer` at `frames` frames of `size` (height, width; the
    pipeline's 480 x 720 when None), `--steps` DPM++ steps, streamed in
    chunks of `stream_chunk` latent frames or decoded whole: the video's
    shape, the wall of a denoise step, `decode_s` and the peak; exact
    launches, B5 on the body `kernel_body` picks at S = T only, no plain
    version called.  12a: 97 frames (T = 25, the long body, 226 + 33,750
    tokens), streamed in chunks of 4 (`bench_vae_decode` measures the
    whole decode); 12d: 801 x 128 x 192 (T = 201, the streamed body, 226 +
    19,296 tokens, about a 49-frame clip's), whole: a ~30-second clip at a
    low resolution.  Fills `launches` with the run's counts."""
    import gc

    import torch
    from bindyouravatar_tpu_torch.config import PipelineConfig
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
    from bindyouravatar_tpu_torch.serving import InferenceServer

    from bindyouravatar_tpu_torch.ops.packed_attention import kernel_body

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    hw = {} if size is None else dict(height=size[0], width=size[1])
    long = BindYourAvatarPipeline.create(
        pipe.dit, pipe.vae, PipelineConfig(num_frames=frames, num_inference_steps=args.steps,
                                           **hw))
    pc = long.cfg
    t_lat = (frames - 1) // pipe.dit.cfg.temporal_compression_ratio + 1
    starts = []
    streamed = {} if stream_chunk is None else dict(
        stream_chunk_frames=stream_chunk, on_chunk=lambda start, arr: starts.append(start))
    req = _serving_request(long, args.seed + 50, f"{frames} frames", **streamed)
    server = InferenceServer(long, dev)
    try:
        with _watch_tiny_seq() as seen:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            res = server.submit(req).result(timeout=1200)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches.update(_read_launches())
    finally:
        server.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd = args.steps * (2 if pc.cfg_microbatch else 1)
    tm = res.timings
    what = f"{frames}-frame request"
    ok = _video_ok(what, res.video, (1, frames, 3, pc.height, pc.width))
    patch = long.dit.cfg.patch_size
    frame_tokens = (pc.height // 8 // patch) * (pc.width // 8 // patch)
    ok &= _counts_ok(what, launches, _serving_want(long.dit, fwd, 0, 1, frame_tokens))
    body = kernel_body(t_lat, long.dit.router_cfg.feat_dim, long.dit.router_cfg.attn_heads)
    ok &= _bodies_ok(what, seen, {(body, t_lat, "fwd")})
    decode = ("whole decode" if stream_chunk is None else
              f"streamed decode, {len(starts)} chunks from frames {starts}")
    print(f"long clip, server (phase {phase}; face + audio, {long.dit.cfg.num_layers} layers, "
          f"{frames} x {pc.height} x {pc.width}, T = {t_lat}, {args.steps} DPM++ steps, "
          f"{decode}): "
          + " ".join(f"{k}={tm[k]:.3f}" for k in ("prep_s", "encode_s", "denoise_s", "decode_s",
                                                   "compute_s"))
          + f"; {tm['denoise_s'] / args.steps:.4f} s a denoise step; wall {wall:.2f} s; peak "
          f"{peak:.2f} GiB {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def long_clip_cli_phase(args, launches: dict) -> bool:
    """Phase 12b: phase 7c's flow (`infer.run` from
    `assets/faces/000_{0,1}.png` through the drawn face nets' checkpoint
    flags, phase 7b's audio and prompt files, weights drawn from `--seed`)
    at `--num_frames 193` (T = 49 latent frames, 226 + 66,150 tokens), 2
    steps, whole decode (its peak: the DiT's weights and the decode's two
    whole-clip activations, `models/vae.py`): the meta line's `seconds`,
    the wall and the peak; the launches of 2 face + audio forwards, B5 on
    its long body at S = 49 only, no plain version called.  Fills
    `launches` with the run's counts."""
    import gc
    import tempfile
    import types

    import torch
    from bindyouravatar_tpu_torch import infer
    from bindyouravatar_tpu_torch.config import AudioConfig, DiTConfig, RouterConfig

    gc.collect()
    torch.cuda.empty_cache()
    frames = 193
    here = os.path.dirname(os.path.abspath(__file__))
    faces = [os.path.join(here, "assets", "faces", f"000_{i}.png") for i in (0, 1)]
    with tempfile.TemporaryDirectory(prefix="bya_cli_long_") as tmp:
        argv = (_cli_inputs(tmp, args.seed + 200)
                + ["--seed", str(args.seed), "--num_frames", str(frames), "--img_file_path",
                   *faces] + _face_checkpoints(tmp, args.seed))
        with _watch_tiny_seq() as seen:
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            res = infer.run(infer.get_args(argv))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches.update(_read_launches())
    peak = torch.cuda.max_memory_allocated() / 2**30
    t_lat = (frames - 1) // 4 + 1
    five_b = types.SimpleNamespace(cfg=DiTConfig(), audio_cfg=AudioConfig(),
                                   router_cfg=RouterConfig())
    what = f"CLI at {frames} frames"
    ok = _video_ok(what, res.video, (1, frames, 3, 480, 720))
    meta_ok = res.meta["frames"] == frames and res.meta["steps"] == 2
    ok &= meta_ok
    ok &= _counts_ok(f"{what} (face + audio)", launches, _serving_want(five_b, 2, 0, 1))
    ok &= _bodies_ok(what, seen, {("long", t_lat, "fwd")})
    print(f"long clip, CLI (phase 12b): --img_file_path assets/faces/000_0.png 000_1.png, the "
          f"drawn face nets, --model_size 5b --num_layers 42 --num_inference_steps 2 "
          f"--num_frames {frames} (T = {t_lat}), whole decode -> run() in {wall:.1f} s (weights "
          f"drawn in fp32 and cast to bf16 included), meta {res.meta}, peak {peak:.2f} GiB "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


# phase 12c's CPU weights and the generator's state after them, drawn by its
# first case and emptied after its last case's card side
_LONG_CLIP_DRAW = {}


def _long_clip_case(frames: int, launches: dict, grid=(12, 18), router_heads: int = 8):
    """One run of phase 12c at `frames` pixel frames on a `grid` (height,
    width) of latents, the router's STABs at `router_heads` heads: the
    card's side now (`launches` takes its micro-batch's counts); returns
    its verdict, which runs the CPU's reference (no CUDA tensor) and
    returns (ok, the gradients' relative L2 errors by name).  See
    `long_clip_model_phase`."""
    import numpy as np
    import torch
    from bindyouravatar_tpu_torch.config import (AudioConfig, DiTConfig, LFEConfig,
                                                 RouterConfig, SchedulerConfig, TrainConfig)
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.ops.packed_attention import kernel_body
    from bindyouravatar_tpu_torch.ops.scheduler import Schedule
    from bindyouravatar_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    rcfg = RouterConfig(num_layers=1, attn_heads=router_heads)
    sub = (AudioConfig(num_layers=2), rcfg, LFEConfig())
    base = dict(num_layers=2, sample_height=grid[0], sample_width=grid[1], sample_frames=frames,
                max_text_seq_length=16, lora_rank=8, lora_alpha=8.0)
    gen = torch.Generator().manual_seed(17)
    make = lambda dtype, dev, fuse, draw=False: DiT.create(
        DiTConfig(dtype=dtype, fuse_qk_norm=fuse, **base), *sub, device=dev,
        generator=gen if draw else None)
    if not _LONG_CLIP_DRAW:
        # the same weights at every frame count, grid and STAB head split
        # (the parameters' shapes do not depend on them): drawn once a phase
        ref = make(torch.float32, "cpu", False, draw=True)
        with torch.no_grad():        # LoRA B off zero, so LoRA A takes gradients too
            for blk in ref.blocks:
                for name in ("to_q_lora_B", "to_k_lora_B"):
                    getattr(blk.attn1, name).normal_(0.0, 0.02, generator=gen)
        _LONG_CLIP_DRAW.update(sd={k: v.clone() for k, v in ref.state_dict().items()},
                               gen=gen.get_state())
    else:
        ref = make(torch.float32, "cpu", False)
        ref.load_state_dict(_LONG_CLIP_DRAW["sd"])
        gen.set_state(_LONG_CLIP_DRAW["gen"])
    sd = ref.state_dict()
    c, a, lf = ref.cfg, ref.audio_cfg, ref.lfe_cfg
    t_lat = c.latent_frames
    n_st = ref.router_cfg.num_attention_layers
    body, body_b = (kernel_body(t_lat, rcfg.feat_dim, router_heads, b) for b in (False, True))

    # the serving forward, batch-2 CFG shapes
    rng = np.random.default_rng(17)
    n_af = c.sample_frames + a.window_size - a.window_stride
    inputs = dict(
        latents=rng.normal(size=(2, t_lat, c.in_channels, c.sample_height, c.sample_width)),
        text_embeds=rng.normal(size=(2, c.max_text_seq_length, c.text_embed_dim)),
        timesteps=np.array([999.0, 499.0]),
        audio_embeds=rng.normal(size=(2, 2, n_af, a.blocks, a.audio_dim)),
        id_cond=rng.normal(size=(2, c.num_ids, lf.id_embed_dim)),
        id_vit_hidden=rng.normal(size=(2, c.num_ids, lf.num_scales, 17, lf.vit_dim)))

    def apply(model, dev):
        t = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in inputs.items()}
        rope = model.rope(c.sample_height * 8, c.sample_width * 8, t_lat, device=dev)
        out, routing = model.apply(t.pop("latents"), t.pop("text_embeds"), t.pop("timesteps"),
                                   rope, **t)
        return out.float().cpu(), routing.float().cpu()

    with torch.inference_mode():
        model = make(torch.bfloat16, "cuda", True)
        model.load_state_dict(sd)
        with _watch_tiny_seq() as fwd_seen:
            torch.cuda.synchronize()
            _reset_launches()
            out_g = apply(model, "cuda")
            torch.cuda.synchronize()
            fwd_counts = _read_launches()
        del model
    want_fwd = {"B5": c.num_ca * n_st, "B5'": 0, "B8": 0}
    fwd_bodies_ok = _bodies_ok(f"T = {t_lat} forward", fwd_seen, {(body, t_lat, "fwd")})

    # one Stage-3 micro-batch: every trainable gradient
    gpu = make(torch.bfloat16, "cuda", False)
    gpu.load_state_dict(sd)
    tcfg = TrainConfig(grad_accum_steps=1)
    trainers = [Trainer(m, Schedule.create(SchedulerConfig()), tcfg) for m in (ref, gpu)]
    for tr in trainers:
        tr.init_state()
    batch = _train_batch(ref, 1, gen, "cpu", vit_tokens=17)
    draws = trainers[0].draw(batch, gen)
    # keep the teacher mask (its dropout would zero the injected routing and
    # with it every perceiver gradient), so those are compared
    draws["keep_mask"][:] = True
    to_gpu = lambda d: {k: None if v is None else v.cuda() for k, v in d.items()}
    with _watch_tiny_seq() as seen_t:
        torch.cuda.synchronize()
        _reset_launches()
        grads_g, m_g = trainers[1].grads_and_metrics(to_gpu(batch), [to_gpu(draws)])
        torch.cuda.synchronize()
        launches.update(_read_launches())
    grads_g = {k: v.float().cpu() for k, v in grads_g.items()}
    m_g = {k: float(v) for k, v in m_g.items()}
    want = train_launches(gpu, 1)
    c_ok = {k: launches[k] for k in want} == want and launches["B8"] > 0
    c_ok &= _bodies_ok(f"T = {t_lat} micro-batch", seen_t,
                       {(body, t_lat, "fwd"), (body_b, t_lat, "bwd")})
    counts, cpu_tr = dict(launches), trainers[0]
    del gpu, trainers
    torch.cuda.empty_cache()
    card_s = time.perf_counter() - t0
    return lambda: _long_clip_verdict(frames, router_heads, rcfg, c, body, ref, apply, cpu_tr,
                                      batch, draws, out_g, fwd_counts, want_fwd, fwd_bodies_ok,
                                      grads_g, m_g, counts, want, c_ok, card_s)


def _long_clip_verdict(frames, router_heads, rcfg, c, body, ref, apply, trainer, batch, draws,
                       out_g, fwd_counts, want_fwd, fwd_bodies_ok, grads_g, m_g, launches,
                       want, c_ok, card_s) -> tuple:
    """`_long_clip_case`'s verdict: the CPU's fp32 forward and micro-batch,
    each against the card's, and the case's line."""
    import torch

    t1 = time.perf_counter()
    t_lat = c.latent_frames
    with torch.inference_mode():
        out_c = apply(ref, "cpu")
    f_rel, r_rel = _rel_l2(out_g[0], out_c[0]), _rel_l2(out_g[1], out_c[1])
    f_ok = ({k: fwd_counts[k] for k in want_fwd} == want_fwd and f_rel <= 0.02
            and bool(out_g[0].isfinite().all()) and fwd_bodies_ok)
    grads_c, m_c = trainer.grads_and_metrics(batch, [draws])
    # tol: metrics within 5% + 1e-3 and the gradients within 3% relative L2
    # each (phases 3e / 3f's), the key biases (true gradient 0) left out;
    # the face path's (perceivers, router, LFE) within phase 3b's 10%: its
    # bf16 roundings pass through the router's sigmoids and 2-way softmaxes,
    # and phase 3b (T = 8, one-tile bodies) puts its multi-ID q / k
    # gradients at 3.8-3.9% on an H100; the control at T = 13 shows the
    # floor that the long bodies do not set
    m_err = {k: abs(m_g[k] - float(m_c[k])) for k in m_c}
    m_ok = all(m_err[k] <= 1e-3 + 0.05 * abs(float(m_c[k])) for k in m_c)
    g_err = {}
    for k, gc_ in grads_c.items():
        if k.endswith("to_k.bias"):
            continue
        norm = float(gc_.norm())
        diff = float((grads_g[k] - gc_).norm())
        g_err[k] = diff / norm if norm > 0 else diff
    g_ok = all(e <= (0.1 if _face_path(k) else 0.03) for k, e in g_err.items())
    ok = f_ok and m_ok and g_ok and c_ok
    shown = lambda cnt, w: " ".join(f"{k}={cnt[k]} (want {w[k]})" for k in w if w[k] or cnt[k])
    worst = lambda pick: " ".join(f"{k}={e:.3e}" for k, e in sorted(
        ((k, e) for k, e in g_err.items() if pick(k)), key=lambda kv: -kv[1])[:3])
    over = sum(e > 0.03 for e in g_err.values())
    print(f"long clip, 2-layer full-width DiT (phase 12c; 48 x 64 heads, dim 3072, STABs "
          f"{router_heads} x {rcfg.feat_dim // router_heads}, face + audio, "
          f"{frames} frames: T = {t_lat}, {body} bodies, {c.sample_height} x {c.sample_width} "
          f"latents, 16 + {c.video_seq_len} tokens): forward cuda-bf16 vs cpu-fp32 relative L2 "
          f"{f_rel:.3e} (tol 0.02), routing {r_rel:.3e}, launches {shown(fwd_counts, want_fwd)}; "
          f"micro-batch loss {m_g['loss']:.5f} / {float(m_c['loss']):.5f}, metrics max "
          f"|d| " + " ".join(f"{k}={v:.2e}" for k, v in m_err.items())
          + f" (tol 1e-3+0.05*|ref|); {len(g_err)} trainable gradients, worst relative L2 "
          f"outside the face path " + worst(lambda k: not _face_path(k)) + " (tol 0.03), the "
          f"temporal STAB attentions' " + worst(lambda k: ".temporal_attn." in k) + ", the face "
          f"path's " + worst(_face_path) + f" (tol 0.1, phase 3b's); {over} above 0.03; "
          f"launches " + shown(launches, want) + f"; card side {card_s:.1f} s, verdict "
          f"{time.perf_counter() - t1:.1f} s " + ("ok" if ok else "FAILED"), flush=True)
    return ok, g_err


def _face_path(name: str) -> bool:
    """A parameter of the DiT's face path: the LFE, the perceivers, the
    router's norms, layer projections and trunk."""
    return name.startswith(("lfe.", "perceivers.", "router_norms.", "router_layers.",
                            "router_trunk."))


def long_clip_model_phase(launches: dict, refs: _References) -> bool:
    """Phase 12c: a 2-layer DiT at the 5B widths (dim 3,072, 48 x 64 heads;
    its audio layers, router and LFE at their own full widths), face +
    audio, at 97 frames (T = 25) on a 12 x 18 latent grid (16 + 1,350
    tokens, cut so that the CPU's fp32 reference runs in seconds), LoRA r8,
    on the card (bf16) against the same weights on the CPU (plain versions,
    fp32): the serving forward (`fuse_qk_norm`) and one Stage-3 micro-batch
    (`Trainer.grads_and_metrics`) at phases 3e / 3f's limits (relative L2
    <= 0.02 forward, <= 0.03 each trainable gradient, the key biases
    apart; the face path's gradients at phase 3b's 0.1; metrics within 5%
    + 1e-3); B5 and B8 on their long bodies at S = 25, no plain version
    called, the launches exact.  Then the same at 49 frames (T = 13, the
    one-tile bodies) as the control: its gradients' errors beside T = 25's.
    Then past each body's cap, on the streamed body, on a 4 x 6 latent
    grid (6 tokens a frame): 801 frames (T = 201, 16 + 1,206 tokens) with
    the 8 x 64 STAB heads, and 193 frames (T = 49, 16 + 294 tokens) with
    `RouterConfig(attn_heads=2)`'s 2 x 256 (cap 48).  Last, B5' on the
    streamed body through `packed_head_attention` at [1001, 201 x 8, 64]
    against its plain version, once, at once; the four cases are queued on
    `refs` (`_References`), and the line of T = 25 beside T = 13 follows
    their verdicts.  Fills `launches["25"]`, `["201"]` and `["49 dh256"]`
    with the micro-batches' counts when their card sides run, and
    `["B5' S201"]` with the direct call's."""
    import torch
    from bindyouravatar_tpu_torch.ops import packed_attention as pa

    for key in ("25", "201", "49 dh256", "B5' S201"):
        launches[key] = {}
    errs = {}

    def start(frames, counts, **kw):
        verdict = _long_clip_case(frames, counts, **kw)

        def judged():
            ok, errs[frames] = verdict()
            return ok
        return judged

    def beside():
        # the draw the cases share is dropped after the last card side
        _LONG_CLIP_DRAW.clear()
        return lambda: _long_clip_beside(errs[97], errs[49])

    refs.add(lambda: start(97, launches["25"]))
    refs.add(lambda: start(49, {}))
    refs.add(lambda: start(801, launches["201"], grid=(4, 6)))
    refs.add(lambda: start(193, launches["49 dh256"], grid=(4, 6), router_heads=2))
    refs.add(beside)
    gen = torch.Generator("cuda").manual_seed(201)
    q, k, v = (torch.randn(1001, 201 * 8, 64, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    torch.cuda.synchronize()
    _reset_launches()
    got = pa.packed_head_attention(q, k, v, 8, 0.125)
    torch.cuda.synchronize()
    launches["B5' S201"].update(_read_launches())
    # tol: phase 2's B5' rows
    err, _, p_ok = _compare(got, pa.packed_head_attention_plain(q, k, v, 8, 0.125), 1e-2, 2e-2)
    n = launches["B5' S201"]
    p_ok &= n["B5'"] == 1 and sum(n.values()) == 1
    print(f"  phase 12c, B5' streamed: packed_head_attention [1001, 201 x 8, 64] against its "
          f"plain version max_abs_err {err:.3e} (tol 1e-2 + 2e-2 |ref|), launches "
          f"{n} (want B5' 1, nothing else) {'ok' if p_ok else 'FAILED'}", flush=True)
    del q, k, v, got
    return p_ok


def _long_clip_beside(errs: dict, errs_13: dict) -> bool:
    """Phase 12c's line of T = 25's gradient errors beside T = 13's."""
    worst = lambda e, pick: max((v for k, v in e.items() if pick(k)), default=0.0)
    print(f"  phase 12c, T = 25 (long bodies) beside T = 13 (one-tile bodies): worst gradient "
          f"error outside the face path {worst(errs, lambda k: not _face_path(k)):.3e} / "
          f"{worst(errs_13, lambda k: not _face_path(k)):.3e}, in the temporal STAB attentions "
          f"{worst(errs, lambda k: '.temporal_attn.' in k):.3e} / "
          f"{worst(errs_13, lambda k: '.temporal_attn.' in k):.3e}, in the face path "
          f"{worst(errs, _face_path):.3e} / {worst(errs_13, _face_path):.3e}", flush=True)
    return True


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
    # B5 and B8 on the long body at 81 and 97 frames (T = 21, 25; timed in
    # phase 2): the launches of phases 12b (its long body at T = 49), 12a
    # and 12c
    "B5 S21": ("cuda", "bindyouravatar_tpu_torch/csrc/packed_attention.cu",
               "bindyouravatar_tpu/ops/packed_attention.py:139"),
    "B5 S25": ("cuda", "bindyouravatar_tpu_torch/csrc/packed_attention.cu",
               "bindyouravatar_tpu/ops/packed_attention.py:139"),
    "B8 S25": ("cuda", "bindyouravatar_tpu_torch/csrc/packed_attention.cu",
               "bindyouravatar_tpu/ops/packed_attention.py:351"),
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
    # the flat kernels at the DiT's other head dims (the same TPU bodies)
    **{f"{name} dh{d}": entry for d in (32, 128) for name, entry in (
        ("B1", ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
                "bindyouravatar_tpu/ops/flash_attention.py:592")),
        ("B7 fwd", ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
                    "bindyouravatar_tpu/ops/flash_attention.py:352")),
        ("B7 bwd", ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention_bwd.cu",
                    "bindyouravatar_tpu/ops/flash_attention.py:1050")))},
    # the head dims the kernels took last, each launched in phase 3f
    **{f"{name} dh{d}": entry for name, ds, entry in (
        ("B7 fwd", (16, 256), ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
                               "bindyouravatar_tpu/ops/flash_attention.py:352")),
        ("B7 bwd", (16, 256), ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention_bwd.cu",
                               "bindyouravatar_tpu/ops/flash_attention.py:1050")),
        ("B11", (16,), ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention.cu",
                        "bindyouravatar_tpu/ops/flash_attention.py:75")),
        ("B12+B13", (16,), ("cuda", "bindyouravatar_tpu_torch/csrc/flash_attention_bwd.cu",
                            "bindyouravatar_tpu/ops/flash_attention.py:919, :981")),
        ("B10 fwd", (16, 256), ("triton", "bindyouravatar_tpu_torch/ops/_ln_triton.py",
                                "bindyouravatar_tpu/ops/layernorm.py:272")),
        ("B10 bwd", (16, 256), ("triton", "bindyouravatar_tpu_torch/ops/_ln_triton.py",
                                "bindyouravatar_tpu/ops/layernorm.py:285"))) for d in ds},
}

# the width rows (`WIDTH_ROWS`) and the token rows (`TOKEN_ROWS`): their
# kernels' sources and TPU bodies
KERNELS.update({row: KERNELS[kernel] for row, kernel in WIDTH_ROWS})
KERNELS.update({row: KERNELS[kernel] for row, kernel, _, _ in TOKEN_ROWS})
# the streamed rows (`STREAM_ROWS`): B5, B5' and B8 past each body's cap
KERNELS.update({row: ("cuda", "bindyouravatar_tpu_torch/csrc/packed_attention_stream.cu",
                      KERNELS[kernel][2]) for row, kernel, _ in STREAM_ROWS})


def _rel_l2(got, want) -> float:
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _ring_check(rnd, b: int, s_real: int, n: int, h: int) -> bool:
    """Every (rank, step) pair of an n-rank ring on one card
    (`ring_attention_local`: `ring_block` / `ring_merge`, kernel B7's
    forward per block), the sequence padded to a multiple of n * 128 as the
    DiT pads it, against B7's unsharded forward with kv_len = s_real."""
    import torch
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops.ring_attention import (block_kv_len, ring_attention_local,
                                                             ring_block)

    s_pad = -(-s_real // (n * 128)) * n * 128
    q, k, v = (rnd(b, s_pad, h * 64).to(torch.bfloat16) for _ in range(3))
    scale = 64 ** -0.5
    ring = lambda: ring_attention_local(q, k, v, h, n, scale, s_real)
    whole = lambda: fa.flash_attention_flat_fwd(q, k, v, h, scale, s_real)
    got, (want, _) = ring(), whole()
    # tol: phase 2's B7 forward, 2% of the output's largest magnitude (+2%
    # relative): each block's p and output are rounded to bf16, the merge
    # is fp32
    atol = _rel_compare(want[:, :s_real], want[:, :s_real], 2e-2)
    err, rel, ok = _compare(got[:, :s_real], want[:, :s_real], atol, 2e-2)
    skipped = sum(block_kv_len(src, s_pad // n, s_real) == 0 for src in range(n))
    shard = [t[:, :s_pad // n].contiguous() for t in (q, k, v)]
    block_ms = _time_ms(lambda: ring_block(*shard, h, 0, scale, s_real), 5)
    ring_ms, whole_ms = _time_ms(ring, 3), _time_ms(whole, 5)
    print(f"distribution ring sp={n} [{b},{s_real},{h * 64}] padded to {s_pad} "
          f"({s_pad // n} rows a shard, {skipped} kv block(s) all padding, skipped at every "
          f"rank): max_abs_err={err:.3e} max_rel_err={rel:.3e} tol=|d|<={atol:.3e}+0.02*|ref| "
          f"{'ok' if ok else 'FAILED'}; a block step {block_ms:.4f} ms, all {n * n} steps with "
          f"the merges (and the shards' copies) {ring_ms:.4f} ms, unsharded B7 forward "
          f"{whole_ms:.4f} ms", flush=True)
    return ok


def distribution_phase(args, phase5: dict) -> bool:
    """Phase 11: distribution and the profiling helpers on the one card.
    The ring's per-block function over all (rank, step) pairs at sp 2 and
    4; an NCCL group of world size 1 driving the sequence-parallel and the
    TP-planned 2-layer full-width `DiT.apply` and the FSDP-sharded Stage-3
    step; B1 and B3 at the TP plan's per-rank heads at tp 2; `trace()` and
    `PhaseTimer` around a forward.  The group is destroyed at the end."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist
    from bindyouravatar_tpu_torch.ops import flash_attention as fa
    from bindyouravatar_tpu_torch.ops import short_kv_attention as skv
    from bindyouravatar_tpu_torch.ops.rope import get_3d_rotary_pos_embed
    from bindyouravatar_tpu_torch.parallel.mesh import init_distributed

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(args.seed + 1100)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    ok = True

    # --- the ring: the joint attention at the DiT's geometry after QK-LN
    # and RoPE, and 300 tokens at sp 4 (the last shard all padding)
    for b, s_real, n in ((2, 17776, 2), (2, 17776, 4), (1, 300, 4), (1, 300, 2)):
        ok &= _ring_check(rnd, b, s_real, n, 48)

    # --- B1 and B3 at the TP plan's per-rank heads at tp 2 (24 of 48); B2's
    # perceivers stay whole under the plan (phase 2's 16 heads)
    # tol: phase 2's B1 and B3 tolerances
    q, k, v = (rnd(2, 17776, 24 * 64).to(bf) for _ in range(3))
    norm = tuple(rnd(64) * 0.1 + (1.0 if i % 2 == 0 else 0.0) for i in range(4))
    rope = get_3d_rotary_pos_embed(64, ((0, 0), (30, 45)), (30, 45), 13, device=dev)
    kern = lambda: fa.flash_attention(q, k, v, 24, rope=rope, rope_start=226, qk_norm=norm)
    plain = lambda: fa.flash_attention_plain(q, k, v, 24, rope=rope, rope_start=226,
                                             qk_norm=norm, block_q=512)
    err, rel, b1_ok = _compare(kern(), plain(), 1e-2, 2e-2)
    print(f"distribution B1 at tp 2's 24 heads [2,17776,1536] QK-LN + RoPE: max_abs_err="
          f"{err:.3e} tol=|d|<=0.01+0.02*|ref| {'ok' if b1_ok else 'FAILED'} kernel_ms="
          f"{_time_ms(kern, 5):.4f} plain_ms={_time_ms(plain, 2):.4f}", flush=True)
    q = rnd(26, 1350, 24 * 64).to(bf)
    k, v = (rnd(26, 2, 24, 32, 64).to(bf) for _ in range(2))
    w = torch.rand((26, 1350, 2), generator=gen, device=dev).to(bf)
    kern = lambda: skv.short_kv_attention_combined_flat(q, k, v, w, 0.125)
    plain = lambda: skv.short_kv_attention_combined_flat_plain(q, k, v, w, 0.125)
    err, rel, b3_ok = _compare(kern(), plain(), 1e-2, 2e-2)
    print(f"distribution B3 at tp 2's 24 heads [26,1350,1536]: max_abs_err={err:.3e} "
          f"tol=|d|<=0.01+0.02*|ref| {'ok' if b3_ok else 'FAILED'} kernel_ms="
          f"{_time_ms(kern, 20):.4f} plain_ms={_time_ms(plain, 5):.4f}", flush=True)
    ok &= b1_ok and b3_ok
    del q, k, v, w

    # --- an NCCL group of world size 1 (no other rank exists on this card)
    store = tempfile.mkdtemp(prefix="bya_pg_")
    init_distributed(coordinator=f"file://{store}/store", num_processes=1, process_id=0,
                     backend="nccl")
    try:
        ok &= _distributed_model_checks(args, phase5, gen, rnd)
    finally:
        dist.destroy_process_group()
    print(f"distribution phase {'ok' if ok else 'FAILED'} in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok


def _distributed_model_checks(args, phase5: dict, gen, rnd) -> bool:
    """The world-size-1 checks of phase 11 (the group is joined)."""
    import gc
    import glob
    import tempfile

    import torch
    import torch.distributed as dist
    from bindyouravatar_tpu_torch.config import DiTConfig
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.parallel.mesh import create_mesh
    from bindyouravatar_tpu_torch.parallel.tp import shard_params_tp, tp_plan
    from bindyouravatar_tpu_torch.utils.profiling import PhaseTimer, sync, trace

    dev = torch.device("cuda")
    ok = True
    world = dist.group.WORLD
    dit = DiT.create(DiTConfig(num_layers=2), device=dev, generator=gen).eval()
    dit.set_fuse_qk_norm(True)
    c = dit.cfg
    batch = _train_batch(dit, 2, gen, dev)
    model_in = torch.cat([batch["video_latents"], batch["image_latents"], batch["bg_latents"]],
                         dim=2)
    rope = dit.rope(480, 720, c.latent_frames, device=dev)
    kw = dict(id_cond=batch["id_cond"], id_vit_hidden=batch["id_vit_hidden"],
              audio_embeds=batch["audio_embeds"], af_matrix=batch["af_matrix"])
    ts = torch.full((2,), 500.0, device=dev)

    def run(**extra):
        _reset_launches()
        with torch.no_grad():
            t0 = time.perf_counter()
            out = dit.apply(model_in, batch["prompt_embeds"], ts, rope, **kw, **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out, _read_launches(), wall

    run()                                    # first calls: warm-up (B10's Triton build)
    run(sp_group=world)
    (fused, r_fused), n_fused, s_fused = run()
    (sp, r_sp), n_sp, s_sp = run(sp_group=world)
    # under sp the blocks' joint attention leaves B1 for B10 (QK-LN) and one
    # B7 forward a ring step (1 step at world size 1)
    want_sp = dict(n_fused, **{"B1": n_fused["B1"] - c.num_layers,
                               "B7 fwd": n_fused["B7 fwd"] + c.num_layers,
                               "B10 fwd": n_fused["B10 fwd"] + 2 * c.num_layers})
    # the witness: the blocks' training path (B10, then B7 with RoPE inside
    # the kernel) on the same inputs, the same launches as the sp path's; it
    # differs from the sp path only where RoPE is applied (and the ring's
    # one-block merge), from the fused path only where QK-LN is
    for blk in dit.blocks:
        blk.attn1.fuse_qk_norm = False
    (unf, r_unf), n_unf, s_unf = run()
    for blk in dit.blocks:
        blk.attn1.fuse_qk_norm = True
    rel_o, rel_r = _rel_l2(sp, fused), _rel_l2(r_sp, r_fused)
    rel_wo, rel_wr = _rel_l2(sp, unf), _rel_l2(r_sp, r_unf)
    rel_uo, rel_ur = _rel_l2(unf, fused), _rel_l2(r_unf, r_fused)
    # tol: the two in-kernel paths differ by their bf16 roundings alone
    # (7.4e-3 / 8.2e-3 on the H100); the sp path may stand at most twice
    # that spread from either (it read 1.07x / 1.11x), and the spread itself
    # within 2e-2
    spread_ok = rel_uo < 2e-2 and rel_ur < 2e-2
    sp_ok = (spread_ok and max(rel_o, rel_wo) < 2 * rel_uo and max(rel_r, rel_wr) < 2 * rel_ur
             and n_sp == want_sp and n_unf == want_sp and bool(sp.isfinite().all()))
    print(f"distribution sp (NCCL world size 1, ring of 1): 2-layer 5B-width DiT.apply "
          f"[2,{c.latent_frames},{c.in_channels},60,90] face + audio, 226 + 17,550 tokens "
          f"padded to 17,792: relative L2 output / routing, the blocks' training path (B10, "
          f"B7 with RoPE inside) against the fused B1 path {rel_uo:.3e} / {rel_ur:.3e} (the "
          f"spread, tol 2e-2); the sp path against the fused {rel_o:.3e} / {rel_r:.3e} and "
          f"against the training path {rel_wo:.3e} / {rel_wr:.3e} (tol 2x the spread: "
          f"{max(rel_o, rel_wo) / rel_uo:.2f}x / {max(rel_r, rel_wr) / rel_ur:.2f}x); "
          f"{s_sp * 1e3:.1f} ms against "
          f"{s_fused * 1e3:.1f} ms fused, {s_unf * 1e3:.1f} ms training path; launches "
          + " ".join(f"{k}={n_sp[k]} (want {want_sp[k]})" for k in want_sp if want_sp[k])
          + f", the training path's equal: {n_unf == want_sp} {'ok' if sp_ok else 'FAILED'}",
          flush=True)
    ok &= sp_ok
    del unf, r_unf

    mesh = create_mesh(dp=1, fsdp=1, tp=1, device_type="cuda")
    shard_params_tp(dit, mesh)
    wrapped = sum(1 for m in dit.modules() if any(
        type(p).__name__ == "DTensor" for p in m.parameters(recurse=False)))
    (tp, r_tp), n_tp, s_tp = run()
    (tp, r_tp), n_tp, s_tp = run()
    bitwise = torch.equal(tp, fused) and torch.equal(r_tp, r_fused)
    rel_t = _rel_l2(tp, fused)
    tp_ok = rel_t < 1e-2 and n_tp == n_fused and bool(tp.isfinite().all())
    print(f"distribution tp (NCCL world size 1): the TP plan wraps {wrapped} modules "
          f"({len(tp_plan(dit, 2))} planned at tp 2, whole heads kept; the same at tp 1), "
          f"2-layer forward against the unsharded one: bit for bit {bitwise}, relative L2 "
          f"{rel_t:.3e} (tol 1e-2); {s_tp * 1e3:.1f} ms against {s_fused * 1e3:.1f} ms; "
          f"launches equal the unsharded run's: {n_tp == n_fused} "
          f"{'ok' if tp_ok else 'FAILED'}", flush=True)
    ok &= tp_ok

    # trace() and PhaseTimer around the same 2-layer forward
    tdir = tempfile.mkdtemp(prefix="bya_trace_")
    timer = PhaseTimer()
    with torch.no_grad():
        with trace(tdir), timer.phase("forward") as holder:
            holder["value"] = dit.apply(model_in, batch["prompt_embeds"], ts, rope, **kw)
    files = glob.glob(os.path.join(tdir, "*.json"))
    text = open(files[0]).read() if files else ""
    symbols = ("flash_fwd_kernel", "short_kv", "layernorm_rows_kernel")
    events = json.loads(text).get("traceEvents", []) if text else []
    dev_ms = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel") / 1e3

    def forward():
        with torch.no_grad():
            dit.apply(model_in, batch["prompt_embeds"], ts, rope, **kw)

    ev = _time_ms(forward, 3)
    t_ok = all(sym in text for sym in symbols) and timer.report()["forward"] > 0
    print(f"distribution profiling: trace() wrote {len(files)} file(s) "
          f"({sum(os.path.getsize(f) for f in files) / 1e6:.1f} MB) naming "
          + ", ".join(f"{sym}={sym in text}" for sym in symbols)
          + f"; kernel time in it {dev_ms:.1f} ms; PhaseTimer (sync) "
          f"{timer.report()['forward'] * 1e3:.1f} ms under the trace, CUDA events around the "
          f"same forward {ev:.1f} ms {'ok' if t_ok else 'FAILED'}", flush=True)
    ok &= t_ok
    sync(holder["value"])
    del dit, fused, sp, tp, holder, batch, model_in
    gc.collect()
    torch.cuda.empty_cache()

    # --- phase 5's Stage-3 step (its seeds: the same weights, batch and
    # draws, at its depth) unsharded again and through `shard_params`
    # (fully_shard over the one rank), against phase 5's result
    ref = phase5 if "after" in phase5 else _stage3_run(args, None)
    again = _stage3_run(args, None, ref)
    s_ = _stage3_run(args, create_mesh(dp=1, fsdp=1, device_type="cuda"), ref)
    f_ok = (s_["rel"] < 1e-2 and s_["frozen_same"] and s_["launches"] == ref["launches"]
            and math.isfinite(s_["loss"]))
    print(f"distribution fsdp (NCCL world size 1): Stage-3 step, AdamW, 2 micro-batches, "
          f"{args.train_layers} layers (phase 5's depth), {s_['wrapped']}/{s_['n']} tensors "
          f"placed by fully_shard over the one rank: trainable change relative L2 against "
          f"phase 5's step {s_['rel']:.3e} (tol 1e-2; key biases apart; the unsharded step "
          f"again {again['rel']:.3e}), frozen bit-identical {s_['frozen_same']}, launches equal "
          f"phase 5's {s_['launches'] == ref['launches']}; step walls sharded "
          + ", ".join(f"{w:.2f}" for w in s_["step_s"]) + " s, unsharded again "
          + ", ".join(f"{w:.2f}" for w in again["step_s"]) + ", phase 5 "
          + ", ".join(f"{w:.2f}" for w in ref["step_s"]) + f" s; peak {s_['peak_gib']:.2f} GiB "
          f"sharded, {again['peak_gib']:.2f} unsharded again, {ref['peak_gib']:.2f} phase 5 "
          f"{'ok' if f_ok else 'FAILED'}", flush=True)
    # where the sharded step's extra peak goes: FSDP2 keeps the root unit
    # gathered from the root's forward to the end of its backward, and each
    # unit's backward holds its unsharded gradients while they are
    # reduce-scattered into the sharded ones
    g = s_["at_root"] - again["at_root"]
    extra = s_["peak_gib"] - again["peak_gib"]
    print(f"distribution fsdp memory (GiB): model {again['model']:.2f} unsharded, "
          f"{s_['model']:.2f} before fully_shard, {s_['placed']:.2f} after it, "
          f"{s_['state']:.2f} with AdamW's state ({again['state']:.2f} unsharded); at the "
          f"root's forward +{s_['at_root']:.2f} over the step's start (unsharded "
          f"+{again['at_root']:.2f}): the root unit's gathered copy {g:.2f} (its wrapped "
          f"tensors {s_['root_gib']:.2f}, {s_['root_train_gib']:.2f} of them trainable; one "
          f"block unit {s_['block_gib']:.3f}); peak {s_['peak_gib']:.2f} against "
          f"{again['peak_gib']:.2f}: extra {extra:.2f} = the gathered root {g:.2f} + the rest "
          f"{extra - g:.2f} (gradient buffers; the root's trainable gradients are "
          f"{s_['root_train_gib']:.2f}); after the steps {s_['end']:.2f} against "
          f"{again['end']:.2f}", flush=True)
    return ok & f_ok & _sharded_optimizer_checks(args, phase5)


def _opt_steps(args, mesh, kw: dict, layers: int, steps: int, start=None, draws=None) -> dict:
    """`steps` optimizer steps of the Stage-3 configuration (`_stage3_setup`
    at `layers`, trainable tensors from `start` if given) with the
    optimizer of `kw` (constant schedule), each step's micro-batches with
    `draws` (or drawn from the setup's generator), unsharded (`mesh` None)
    or through `shard_params`: walls, peak, loss and the trainable tensors
    after the steps (and, without `start`, before them; on the host)."""
    import gc

    import torch
    from bindyouravatar_tpu_torch.config import TrainConfig
    from bindyouravatar_tpu_torch.parallel.sharding import local

    gc.collect()
    torch.cuda.empty_cache()
    dit, tr, state, batch, gs = _stage3_setup(
        args, mesh, None, TrainConfig(lr_scheduler="constant", **kw), layers, start)
    accum = tr.cfg.grad_accum_steps
    before = None if start is not None else {
        k: local(p).detach().to("cpu", copy=True) for k, p in tr.trainable.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        d = draws or [tr.draw({"video_latents": batch["video_latents"][j:j + 1]}, gs)
                      for j in range(accum)]
        grads, m = tr.grads_and_metrics(batch, d)
        state = tr.apply_gradients(state, grads)
        del grads
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out = dict(step_s=walls, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               loss=float(m["loss"]), sharded=len(tr.parts), before=before,
               after={k: local(p).detach().to("cpu", copy=True) for k, p in tr.trainable.items()})
    del dit, tr, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sharded_optimizer_checks(args, phase5: dict) -> bool:
    """Adafactor, 8-bit AdamW and prodigy through `shard_params` over the
    one rank (every trainable tensor a part: the optimizers' sums over the
    fsdp group run, over NCCL), each against its unsharded step within
    relative L2 1e-2 of the trainable change (key biases apart), the
    bound AdamW's sharded step is held to, or twice the unsharded step's
    own run-to-run floor where that is larger: adafactor's first step is
    g / sqrt(g^2 + 1e-30), +-1 wherever g is nearly 0, so the run-to-run
    noise of B7's dq (added in no fixed order) flips whole elements of its
    change, and its floor is read by running the unsharded step again.
    Adafactor and 8-bit AdamW: one step at phase 5's depth from phase 5's
    trainable tensors with phase 5c's draws, against phase 5c's step (run
    here when phase 5c did not run).
    Prodigy: 2 steps at 8 layers, lr 10 (its d grows from the second step),
    unsharded and sharded: at phase 5's 42 layers its unsharded peak (73.69
    GiB) and the sharded root unit's gathered copy (8.12 GiB) pass the 80
    GB card."""
    import torch
    from bindyouravatar_tpu_torch.parallel.mesh import create_mesh

    ok = True
    mesh = lambda: create_mesh(dp=1, fsdp=1, device_type="cuda")
    fivec = phase5.get("5c", {})
    start = phase5.get("after")
    cases = [(name, OPTIMIZER_RUNS[name], args.train_layers, 1) for name in
             ("adafactor", "adamw 8-bit")]
    cases.append(("prodigy", dict(OPTIMIZER_RUNS["prodigy"], learning_rate=10.0), 8, 2))

    def rel_change(got, ref, before):
        num = den = 0.0
        for k, t in got.items():
            if k.endswith("to_k.bias"):
                continue
            r = ref[k].double()
            num += float((t.double() - r).square().sum())
            den += float((r - before[k].double()).square().sum())
        return (num / max(den, 1e-30)) ** 0.5

    for name, kw, layers, steps in cases:
        t0 = time.perf_counter()
        if name in fivec and start is not None:
            ref, src = fivec[name], "phase 5c's step"
            begin, draws = start, fivec["draws"]
        else:       # prodigy, or phase 5 did not run: both from the seed's draw
            begin = start if name != "prodigy" else None
            draws = None
            ref, src = _opt_steps(args, None, kw, layers, steps, begin), "unsharded again"
        got = _opt_steps(args, mesh(), kw, layers, steps, begin, draws)
        before = begin if begin is not None else ref["before"]
        rel = rel_change(got["after"], ref["after"], before)
        floor, tol = None, 1e-2
        if name == "adafactor":
            again = _opt_steps(args, None, kw, layers, steps, begin, draws)
            floor = rel_change(again["after"], ref["after"], before)
            tol = max(tol, 2 * floor)
            del again
        o_ok = rel < tol and math.isfinite(got["loss"]) and got["sharded"] > 0
        ok &= o_ok
        shown = "" if floor is None else f"; the unsharded step again {floor:.3e}"
        print(f"distribution fsdp {name} (NCCL world size 1): {steps} step(s), 2 micro-batches, "
              f"{layers} layers, {got['sharded']} trainable tensors as parts: trainable change "
              f"relative L2 against {src} {rel:.3e} (tol {tol:.3e}{shown}; key biases apart), loss "
              f"{got['loss']:.6g} / {ref['loss']:.6g}; step walls sharded "
              + ", ".join(f"{w:.2f}" for w in got["step_s"]) + f" s, {src} "
              + ", ".join(f"{w:.2f}" for w in ref["step_s"]) + f" s; peak "
              f"{got['peak_gib']:.2f} GiB sharded, {ref['peak_gib']:.2f} GiB {src}; "
              f"{time.perf_counter() - t0:.1f} s {'ok' if o_ok else 'FAILED'}", flush=True)
    return ok


def _stage3_setup(args, mesh=None, mem=None, tcfg=None, layers=None, start=None):
    """Phase 5's Stage-3 configuration from its seeds: the repo's default
    `DiTConfig(lora_rank=128, remat=True, remat_policy="nested")` at
    `layers` (default `--train-layers`), drawn on the card, its trainer
    (`tcfg`, default phase 5's AdamW; through `shard_params` over `mesh`)
    with its trainable tensors set to `start` (name -> whole tensor) if
    given, and the optimizer's state, the batch, and the generator of the
    steps' draws.  `mem` (if given) takes the device GiB after the model,
    its placement and the state."""
    import torch
    from bindyouravatar_tpu_torch.config import DiTConfig, SchedulerConfig, TrainConfig
    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.ops.scheduler import Schedule
    from bindyouravatar_tpu_torch.training.trainer import Trainer

    mem = {} if mem is None else mem
    gib = lambda: torch.cuda.memory_allocated() / 2**30
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed + 100)
    cfg = DiTConfig(lora_rank=128, remat=True, remat_policy="nested",
                    num_layers=layers or args.train_layers)
    dit = DiT.create(cfg, device=dev, generator=gen)
    mem["model"] = gib()
    tr = Trainer(dit, Schedule.create(SchedulerConfig()), tcfg or TrainConfig(lr_warmup_steps=1),
                 mesh=mesh)
    mem["placed"] = gib()
    if start is not None:
        from bindyouravatar_tpu_torch.parallel.sharding import local

        with torch.no_grad():
            for k, p in tr.trainable.items():
                local(p).copy_(start[k])      # one rank: its part is the whole tensor
    state = tr.init_state()
    mem["state"] = gib()
    batch = _train_batch(dit, tr.cfg.grad_accum_steps, gen, dev)
    return dit, tr, state, batch, torch.Generator(dev).manual_seed(args.seed + 200)


def _stage3_run(args, mesh, ref=None) -> dict:
    """Phase 5's Stage-3 steps (`_stage3_setup`: the same weights, batch
    and draws), unsharded (`mesh` None) or
    through `shard_params` over `mesh`: walls, launches, memory readings
    and, against `ref` (phase 5's record), the trainable change's relative
    L2 (key biases apart).  Returns a record with phase 5's keys (and,
    without `ref`, the trainable tensors after the steps, on the host)."""
    import gc
    import re

    import torch
    from bindyouravatar_tpu_torch.parallel.sharding import local

    gib = lambda: torch.cuda.memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    out = {}
    dit, tr, state, batch, gs = _stage3_setup(args, mesh, out)
    before = {k: local(p).detach().to("cpu", copy=True) for k, p in tr.trainable.items()}
    # fingerprints a 2^27-element piece at a time (the int64 words of the
    # largest frozen tensor whole are 9 GiB)
    fp = lambda t: tuple(_fingerprint(c) for c in local(t).detach().reshape(-1).split(1 << 27))
    frozen = {k: fp(p) for k, p in tr.frozen.items()}
    is_d = lambda p: type(p).__name__ == "DTensor"
    unit = re.compile(r"^(blocks|audio_layers|router_layers)\.\d+\.")
    size = lambda names: sum(p.numel() * p.element_size() for n, p in dit.named_parameters()
                             if n in names and is_d(p)) / 2**30
    named = dict(dit.named_parameters())
    root = {n for n in named if not unit.match(n)}
    out.update(root_gib=size(root), root_train_gib=size(root & set(tr.trainable)),
               block_gib=size({n for n in named if n.startswith("blocks.0.")}),
               wrapped=sum(1 for p in named.values() if is_d(p)), n=len(named))
    marks = []
    hook = dit.register_forward_pre_hook(lambda m, a: marks.append(gib()))
    accum = tr.cfg.grad_accum_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = gib()
    _reset_launches()
    walls = []
    for _ in range(args.train_steps):
        t0 = time.perf_counter()
        draws = [tr.draw({"video_latents": batch["video_latents"][j:j + 1]}, gs)
                 for j in range(accum)]
        state, m = tr.train_step(state, batch, draws=draws)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    hook.remove()
    out.update(step_s=walls, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=_read_launches(),
               loss=float(m["loss"]), at_root=marks[0] - start, end=gib())
    print(f"distribution fsdp run ({'sharded' if mesh is not None else 'unsharded'}): walls "
          + ", ".join(f"{w:.2f}" for w in walls) + f" s, peak {out['peak_gib']:.2f} GiB, at the "
          f"root's forward +{out['at_root']:.2f}, after the steps {out['end']:.2f}", flush=True)
    out["frozen_same"] = all(fp(p) == frozen[k] for k, p in tr.frozen.items())
    after = {k: local(p).detach() for k, p in tr.trainable.items()}
    if ref is None:
        out["after"] = {k: t.to("cpu", copy=True) for k, t in after.items()}
    else:
        num = den = 0.0
        for k, t in after.items():
            if k.endswith("to_k.bias"):
                continue
            r = ref["after"][k].to(dev).double()
            num += float((t.double() - r).square().sum())
            den += float((r - before[k].to(dev).double()).square().sum())
        out["rel"] = (num / max(den, 1e-30)) ** 0.5
    del dit, tr, state, batch, after, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2, help="denoise steps per request")
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-steps", type=int, default=2, help="optimizer steps of phase 5")
    p.add_argument("--train-layers", type=int, default=4,
                   help="depth of the phase-5 DiT (widths stay full; cut from 42 for the "
                        "smoke's time: phases 5, 5b, 5c and 11 step it)")
    p.add_argument("--clip-steps", type=int, default=10,
                   help="denoise steps of phase 7's clip (a shipped clip takes 50: cut for the "
                        "smoke's time; 0 skips phases 7 to 7e)")
    p.add_argument("--request-layers", type=int, default=8,
                   help="depth of phases 3g's and 3i's serving requests (widths stay full; cut "
                        "from 42 for the smoke's time: phases 4, 7 and 12 serve at 42)")
    p.add_argument("--driver-layers", type=int, default=4,
                   help="depth of the phase-6 DiT (widths stay full; cut from 42: a save at 42 "
                        "layers writes 32.4 GB, the phase saves twice, and a run may write 45 "
                        "GiB, 18 GB of them phase 7e's files)")
    p.add_argument("--only-distribution", action="store_true",
                   help="build, then run phase 11 only; fails on purpose (no launch counts)")
    p.add_argument("--only-head-dims", action="store_true",
                   help="build, then run phases 3g and 3h only (the face + audio DiT at the "
                        "other head splits, its 42-layer request, the width entry points); "
                        "fails on purpose (no launch counts of the main path)")
    p.add_argument("--only-tokens", action="store_true",
                   help="build, then run phase 3i only (the face + audio DiT at other token "
                        "and identity counts, its 42-layer request, the token rows' entry "
                        "points); fails on purpose (no launch counts of the main path)")
    p.add_argument("--face-plain", action="store_true",
                   help="ROADMAP C5: build, then rerun phase 3g's 24 x 128 and phase 12c's "
                        "face + audio micro-batches with the face path's kernels (B2, B4, "
                        "B5 / B5' / B8) swapped for their plain versions in fp32 (inside "
                        "this process: the package has no such switch), printing the face "
                        "path's gradient errors; fails on purpose")
    p.add_argument("--only-long-clips", action="store_true",
                   help="build, then run phase 12 only (12a on a model of its own); fails on "
                        "purpose (no launch counts)")
    p.add_argument("--only-kernels", metavar="NAMES",
                   help="run phase 2 for these kernels only (comma-separated names of the "
                        "kernels line, or their first word: 'B2,B3,B7'), then stop; fails on "
                        "purpose (no launch counts).  Run in two unpacked trees, it times two "
                        "versions of the kernels in one call")
    args = p.parse_args(argv)
    t_main = time.perf_counter()

    def lap(what: str, since: float) -> float:
        now = time.perf_counter()
        print(f"{what} in {now - since:.1f} s ({now - t_main:.1f} s since the start)",
              flush=True)
        return now

    only = None
    if args.only_kernels:
        only = {n.strip() for n in args.only_kernels.split(",") if n.strip()}
        known = {n.split()[0] for n in KERNELS} | set(HEAD_DIM_CLASSES)
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
          f"flash backward of B7 and B12 + B13, B2 + B3 + B14 + B2c + B2h, B5 + B8, their "
          f"streamed bodies, B6 + B9) and triton import in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = [ln for ln in (lib.parent / "nvcc.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln
             or ln.startswith("== ")]
    for line in ptxas:
        print(f"  ptxas: {line.strip()}", flush=True)

    results, launches, reduced_launches, train_launches_ = {}, {}, {}, {}
    unpaired_launches, entry_launches = {}, {}
    if args.only_distribution:
        ok = distribution_phase(args, {})
        return _fail(f"--only-distribution: phase 11 {'passed' if ok else 'FAILED'}, no other "
                     f"phase run")
    if args.only_head_dims:
        t3, refs = time.perf_counter(), _References()
        ok = head_dim_face_phase(args, {}, refs) & width_entry_phase({})
        ok &= refs.drain()
        return _fail(f"--only-head-dims: phases 3g and 3h {'passed' if ok else 'FAILED'} in "
                     f"{time.perf_counter() - t3:.1f} s, no other phase run")
    if args.only_tokens:
        t3, refs = time.perf_counter(), _References()
        ok = token_phase(args, {}, refs)
        ok &= refs.drain()
        return _fail(f"--only-tokens: phase 3i {'passed' if ok else 'FAILED'} in "
                     f"{time.perf_counter() - t3:.1f} s, no other phase run")
    if args.face_plain:
        t3 = time.perf_counter()
        face_plain_phase()
        return _fail(f"--face-plain: the C5 runs done in {time.perf_counter() - t3:.1f} s, no "
                     f"other phase run")
    long_launches, cli_launches, model_launches = {}, {}, {}
    if args.only_long_clips:
        t12, refs = time.perf_counter(), _References()
        ok = long_clip_requests(args, _serving_model(args, args.steps), long_launches)
        ok &= long_clip_cli_phase(args, cli_launches)
        ok &= long_clip_model_phase(model_launches, refs)
        ok &= refs.drain()
        return _fail(f"--only-long-clips: phase 12 {'passed' if ok else 'FAILED'} in "
                     f"{time.perf_counter() - t12:.1f} s, no other phase run")
    t2 = time.perf_counter()
    ok = kernel_phase(results, only)
    t = lap("phase 2", t2)
    if only is not None:
        return _fail(f"--only-kernels: phase 2 of {sorted(only)} {'passed' if ok else 'FAILED'}, "
                     f"no other phase run")
    ok &= reduced_step_phase(reduced_launches)
    ok &= reduced_train_phase({})
    ok &= reduced_train_phase(unpaired_launches, unpaired=True)
    ok &= entry_point_phase(entry_launches)
    t = lap("phases 3a to 3d", t)
    # the 2-layer full-width DiT cases of phases 3e-3i and 12c: their card
    # sides at each pump, their CPU references on `refs`' worker beside the
    # phases that follow (none of which is timed per kernel), every verdict
    # in before phase 11
    refs = _References()
    head_dim_launches, width_launches, token_launches = {}, {}, {}
    head_dim_phase(head_dim_launches, refs)
    head_dim_model_phase(head_dim_launches, refs)
    refs.pump()
    ok &= head_dim_face_phase(args, width_launches, refs)
    refs.pump()
    ok &= width_entry_phase(width_launches)
    refs.pump()
    ok &= token_phase(args, token_launches, refs)
    refs.pump()
    ok &= long_clip_model_phase(model_launches, refs)
    refs.pump()
    t = lap("phases 3e to 3i and 12c (card sides of the first cases, the requests and entry "
            "points)", t)
    if args.requests > 0:
        ok &= serving_phase(args, long_launches)
    else:
        ok = False
        print("serving phase skipped (--requests 0): no launch counts", flush=True)
    refs.pump()
    t = lap("phases 4, 12a and 12d", t)
    phase5 = {}
    if args.train_steps > 0:
        ok &= train_phase(args, train_launches_, phase5)
    else:
        ok = False
        print("train phase skipped (--train-steps 0): no launch counts", flush=True)
    refs.pump()
    t = lap("phase 5", t)
    ok &= driver_phase(args)
    refs.pump()
    t = lap("phase 6", t)
    if args.clip_steps > 0:
        peaks = {}
        ok &= clip_phase(args, launches)
        refs.pump()
        ok &= cli_phase(args, peaks)
        refs.pump()
        ok &= cli_face_phase(args, peaks)
        ok &= cli_two_stage_phase(args, peaks)
        # phase 7e reads the host's RSS: no reference model beside it (no
        # case started since 7b, so the wait is short)
        refs.quiet()
        t = lap("phases 7 to 7d", t)
        ok &= cli_reference_phase(args, peaks)
        refs.pump()
        t = lap("phase 7e", t)
    else:
        ok = False
        print("clip phases skipped (--clip-steps 0): no launch counts", flush=True)
    ok &= encoder_phase(args)
    refs.pump()
    ok &= wav2vec_phase(args)
    refs.pump()
    ok &= sam2_upscaler_phase(args)
    refs.pump()
    t = lap("phases 8 to 10", t)
    ok &= two_b_phase(args)
    refs.pump()
    t = lap("the 2B phase", t)
    ok &= long_clip_cli_phase(args, cli_launches)
    t = lap("phase 12b", t)
    ok &= refs.drain()
    t = lap("the rest of phases 3e to 3i and 12c", t)
    ok &= distribution_phase(args, phase5)
    lap("phase 11", t)
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
    # B1 and B7 at head dims 32 and 128: the 2-layer full-width DiTs of phase
    # 3e; B7, B11, B12 + B13 and B10 at 16 and 256: those of phase 3f
    launches.update(head_dim_launches)
    # the long body: B5 at 97 frames, phase 12a's request; at T = 21 (timed
    # in phase 2), the long body's launches in phase 12b's CLI run at 193
    # frames (T = 49); B8 at T = 25: phase 12c's micro-batch.  The streamed
    # body: B5 at T = 201, phase 12d's request; B8 at T = 201 and both at dh
    # 256 (T = 49), phase 12c's micro-batches; B5', phase 12c's direct call
    launches.update({"B5 S25": long_launches["12a"]["B5"], "B5 S21": cli_launches["B5"],
                     "B8 S25": model_launches["25"]["B8"],
                     "B5 S201": long_launches["12d"]["B5"],
                     "B5' S201": model_launches["B5' S201"]["B5'"],
                     "B8 S201": model_launches["201"]["B8"],
                     "B5 dh256 S49": model_launches["49 dh256"]["B5"],
                     "B8 dh256 S49": model_launches["49 dh256"]["B8"]})
    # the short-KV and packed kernels at the other widths: the DiTs and
    # routers of phase 3g (B3 at 16, 32, 128, 256; B4, B5, B8 at 32, 128),
    # the entry points of phase 3h (the rest)
    launches.update(width_launches)
    # the short-KV kernels at other token and identity counts: the entry
    # points of phase 3i (and its setting (b)'s B3 launches)
    launches.update(token_launches)
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
