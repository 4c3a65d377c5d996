"""Validation in training (the port of the JAX package's
`training/validation.py`, the reference's `log_validation`,
`train.py:103-203`): at every checkpoint, generate videos with the live
DiT and write `{output_dir}/validation-{step}/video_{i}.mp4`.

The pipeline wraps the trainer's own DiT.  A generate runs under
`torch.no_grad()` on the inference path (`set_fuse_qk_norm(True)`: the
fused QK-LN has no backward) and the DiT goes back to the training path
after it.  Tensors the driver passes that are not the DiT's own (the EMA
copy) are copied in for the call and the live values put back after.
A DiT placed with `parallel.sharding.shard_params` runs on every rank
(its root unit gathered for the call, each block gathered by its own
hooks); rank 0 writes the mp4s.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch


def make_validation_fn(pipe, output_dir: str, prompt_embeds: np.ndarray,
                       cond: Optional[Dict[str, torch.Tensor]] = None,
                       num_inference_steps: int = 8, num_videos: int = 1,
                       seed: int = 0) -> Callable[[int, Mapping[str, torch.Tensor]], None]:
    """`validation_fn(step, named)` for `TrainDriver.run`: `named` is the
    DiT's parameters by name (`TrainDriver`'s merge of the trainable or EMA
    tensors and the frozen ones).  Video i draws from a generator seeded
    `seed + i`; the negative prompt and the conditioning image are zeros,
    the mp4 25 fps, as JAX's defaults; `cond` goes to `generate`."""
    from ..utils.media import export_to_video

    dit = pipe.dit
    c = dit.cfg
    dev = next(dit.parameters()).device
    pe = torch.as_tensor(np.asarray(prompt_embeds, np.float32), device=dev)
    ne = torch.zeros_like(pe)
    img = torch.zeros((pe.shape[0], 1, 3, c.sample_height * 8, c.sample_width * 8), device=dev)
    cond = cond or {}

    @torch.no_grad()
    def validation_fn(step: int, named: Mapping[str, torch.Tensor]) -> None:
        live = dict(dit.named_parameters())
        swapped = {k: live[k].detach().clone() for k, t in named.items() if t is not live[k]}
        for k in swapped:
            live[k].copy_(named[k])
        sharded = hasattr(dit, "unshard")       # an FSDP unit: gather its root's tensors
        lead = not sharded or torch.distributed.get_rank() == 0
        out_dir = os.path.join(output_dir, f"validation-{step}")
        if lead:
            os.makedirs(out_dir, exist_ok=True)
        dit.set_fuse_qk_norm(True)
        if sharded:
            dit.unshard()
        try:
            for i in range(num_videos):
                gen = torch.Generator(dev).manual_seed(seed + i)
                video = pipe.generate(pe, ne, img, gen, num_inference_steps=num_inference_steps,
                                      **cond)
                if not lead:
                    continue
                path = os.path.join(out_dir, f"video_{i}.mp4")
                export_to_video(video[0].float().cpu().numpy(), path, fps=25)
                print(f"[validation] step {step}: wrote {path}", flush=True)
        finally:
            if sharded:
                dit.reshard()
            dit.set_fuse_qk_norm(False)
            for k, t in swapped.items():
                live[k].copy_(t)

    return validation_fn
