"""BindYourAvatar inference pipeline in torch (port of
`bindyouravatar_tpu/pipeline/pipeline.py`).

VAE encode of the conditioning image -> CFG denoise loop (batch-2 CFG by
default, two sequential halves with `cfg_microbatch`) over `DiT.apply` with
DPM++ or DDIM steps -> VAE decode.  The loop is a host loop over eagerly
run modules; the face tokens (LFE) and the audio context are computed once
per clip, outside it.
Randomness comes from an explicit `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PipelineConfig, SchedulerConfig
from ..models.dit import DiT
from ..models.vae import CausalVAE
from ..ops.scheduler import Schedule


def cfg_double(x: Optional[torch.Tensor], zero_uncond: bool) -> Optional[torch.Tensor]:
    """[B, ...] -> [2B, ...]: uncond half first (zeros if `zero_uncond`)."""
    if x is None:
        return None
    return torch.cat([torch.zeros_like(x) if zero_uncond else x, x], dim=0)


def temporal_or_routing(routing: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
    """Forced/teacher masks are OR-reduced over time then repeated
    (reference `transformer.py:747-749, 815-818`).  routing: [B, S, I]."""
    t, h, w = grid
    b, s, i = routing.shape
    r = routing.reshape(b, t, h, w, i).amax(dim=1, keepdim=True)
    return r.expand(b, t, h, w, i).reshape(b, s, i)


@dataclasses.dataclass
class BindYourAvatarPipeline:
    dit: DiT
    vae: CausalVAE
    schedule: Schedule
    cfg: PipelineConfig = PipelineConfig()
    # a process group: every DiT step runs its joint attention as ring
    # attention over its ranks (sequence parallelism; JAX's `sp_mesh`)
    sp_group: Any = None

    @classmethod
    def create(cls, dit: DiT, vae: CausalVAE, cfg: PipelineConfig = PipelineConfig(),
               sched_cfg: SchedulerConfig = SchedulerConfig()) -> "BindYourAvatarPipeline":
        """The pipeline only runs the DiT forward, so it switches the DiT to
        the inference path (`fuse_qk_norm`: QK-LN and RoPE inside kernel B1),
        as the JAX `create` does; the switch is made in place."""
        if dit.cfg.qk_norm and not dit.cfg.fuse_qk_norm:
            dit.set_fuse_qk_norm(True)
        return cls(dit=dit, vae=vae, schedule=Schedule.create(sched_cfg), cfg=cfg)

    def prepare_image_latents(self, image: torch.Tensor, latent_frames: int) -> torch.Tensor:
        """Encode the conditioning image and zero-pad to `latent_frames`."""
        lat = self.vae.encode(image)                                  # [B,1,C,h,w]
        pad = lat.new_zeros((lat.shape[0], latent_frames - lat.shape[1]) + lat.shape[2:])
        return torch.cat([lat, pad], dim=1)

    def prepare_denoise_inputs(self, prompt_embeds, image_latents, steps, *,
                               generator: torch.Generator, bg_latents=None, id_cond=None,
                               id_vit_hidden=None, audio_embeds=None, mute_embeds=None,
                               af_matrix=None, routing_forcing=None,
                               latents=None) -> Dict[str, object]:
        """CFG doubling, the per-clip face tokens and audio context, the
        forced routing, RoPE tables, the timestep schedule and the initial
        latents."""
        c = self.cfg
        b, t_lat, ch, h_lat, w_lat = image_latents.shape
        dev = image_latents.device
        ts = self.schedule.timesteps(steps)
        prev_ts = ts - self.schedule.config.num_train_timesteps // steps
        ts_back = np.concatenate([[ts[0]], ts[:-1]])
        rope = self.dit.rope(h_lat * 8, w_lat * 8, t_lat, base_height_px=c.base_height,
                             base_width_px=c.base_width, device=dev)
        force2 = None
        if routing_forcing is not None:
            force2 = temporal_or_routing(torch.cat([routing_forcing] * 2, dim=0),
                                         self._forcing_grid(t_lat, h_lat, w_lat))
        # raw inputs are doubled BEFORE the context precompute, so the uncond
        # half sees zeroed inputs (the LFE or projection of zeros is not zeros)
        idc2 = cfg_double(id_cond, c.zero2cond_cfg)
        vit2 = cfg_double(id_vit_hidden, c.zero2cond_cfg)
        audio2 = cfg_double(audio_embeds, True)
        face2, actx2 = self.dit.prepare_conditioning(
            id_cond=idc2, id_vit_hidden=vit2, audio_embeds=audio2, mute_embeds=mute_embeds,
            num_pixel_frames=c.num_frames)
        af2 = cfg_double(af_matrix, c.zero2cond_cfg)
        if actx2 is not None and af2 is None:
            af2 = torch.eye(self.dit.cfg.num_ids, device=dev)[None].repeat(2 * b, 1, 1)
        if latents is None:
            latents = torch.randn((b, t_lat, ch, h_lat, w_lat), generator=generator,
                                  device=dev, dtype=torch.float32)
        return dict(
            pe=prompt_embeds, img=cfg_double(image_latents, c.zero2cond_cfg),
            bg=None if bg_latents is None else torch.cat([bg_latents] * 2, dim=0),
            face=face2, actx=actx2, af=af2, force=force2, rope=rope, latents=latents,
            ts=[int(x) for x in ts], prev_ts=[int(x) for x in prev_ts],
            ts_back=[int(x) for x in ts_back])

    def _forcing_grid(self, t_lat: int, h_lat: int, w_lat: int) -> Tuple[int, int, int]:
        """The grid a forced routing is OR-reduced on: the DiT config's
        `latent_grid`, as in the JAX pipeline.  Latents whose (t, h*w) differ
        from it raise: there JAX's reshape fails or, at the same token count
        with another t, mixes frames."""
        grid = self.dit.cfg.latent_grid
        p = self.dit.cfg.patch_size
        got = (t_lat, (h_lat // p) * (w_lat // p))
        if got != (grid[0], grid[1] * grid[2]):
            raise ValueError(f"routing_forcing needs latents on the DiT config's latent grid "
                             f"(t, h*w) = ({grid[0]}, {grid[1] * grid[2]}); got {got}")
        return grid

    def _guided(self, inp, lat, t_cur):
        """(The CFG-guided model output for latents `lat` at timestep t_cur,
        the cond half's routing predictions [num_ca, B, S, I] or None)."""
        c = self.cfg
        b = lat.shape[0]

        def fwd(sel, lat_in):
            chans = [lat_in, sel(inp["img"])]
            if inp["bg"] is not None:
                chans.append(sel(inp["bg"]))
            model_in = torch.cat(chans, dim=2)
            tvec = torch.full((model_in.shape[0],), float(t_cur), device=lat.device)
            pred, routing = self.dit.apply(model_in, sel(inp["pe"]), tvec, inp["rope"],
                                           face_emb=sel(inp["face"]), audio_ctx=sel(inp["actx"]),
                                           af_matrix=sel(inp["af"]),
                                           routing_override=sel(inp["force"]),
                                           sp_group=self.sp_group)
            return pred.float(), routing

        if c.cfg_microbatch:
            half = lambda h: (lambda x: None if x is None else x[h * b:(h + 1) * b])
            (un, _), (txt, routing) = fwd(half(0), lat), fwd(half(1), lat)
        else:
            pred, routing = fwd(lambda x: x, torch.cat([lat, lat], dim=0))
            un, txt = pred.chunk(2, dim=0)
            routing = None if routing is None else routing[:, b:]
        g = c.guidance_scale
        if c.use_dynamic_cfg:
            # the reference formula mixes the timestep VALUE with the step
            # count, so cos sees arguments near 1e14: computed in float32 as
            # the JAX loop does, since the result depends on the precision
            f32 = np.float32
            x = f32(len(inp["ts"]) - t_cur) / f32(len(inp["ts"]))
            g = float(1 + g * (1 - np.cos(f32(math.pi) * x ** f32(5))) / 2)
        return un + g * (txt - un), routing

    @torch.inference_mode()
    def denoise(self, prompt_embeds, image_latents, generator: torch.Generator, *,
                bg_latents=None, id_cond=None, id_vit_hidden=None, audio_embeds=None,
                mute_embeds=None, af_matrix=None, routing_forcing=None,
                num_inference_steps: Optional[int] = None, guidance_scale: Optional[float] = None,
                latents: Optional[torch.Tensor] = None,
                noise: Optional[Sequence[torch.Tensor]] = None, return_routing: bool = False):
        """The CFG denoise loop -> final latents [B, T, C, h, w].
        `prompt_embeds` is CFG-doubled [2B, L, D] (uncond first); id_cond
        [B, I, 1280], id_vit_hidden [B, I, 5, 577, 1024], audio_embeds
        [B, tracks, A, 12, 768], af_matrix [B, I, I], routing_forcing
        [B, S, I] (OR-reduced over time, then used in place of the
        predicted routing).  `noise`: one tensor per step for the DPM++ SDE
        term (drawn from `generator` when None).  With `return_routing`
        (the `--draw_routing_logits` debug surface) returns (latents,
        routing [steps, num_ca, B, S, I] bf16 of the cond CFG half, or None
        when the face path did not run)."""
        steps = num_inference_steps or self.cfg.num_inference_steps
        pipe = self
        if guidance_scale is not None:
            pipe = dataclasses.replace(
                self, cfg=dataclasses.replace(self.cfg, guidance_scale=guidance_scale))
        inp = pipe.prepare_denoise_inputs(
            prompt_embeds, image_latents, steps, generator=generator, bg_latents=bg_latents,
            id_cond=id_cond, id_vit_hidden=id_vit_hidden, audio_embeds=audio_embeds,
            mute_embeds=mute_embeds, af_matrix=af_matrix, routing_forcing=routing_forcing,
            latents=latents)
        sched = self.schedule
        lat = inp["latents"].float()
        old_pred = torch.zeros_like(lat)
        routing = []
        for i, t_cur in enumerate(inp["ts"]):
            guided, r = pipe._guided(inp, lat, t_cur)
            if return_routing and r is not None:
                routing.append(r.to(torch.bfloat16))
            if self.cfg.scheduler_type == "ddim":
                lat = sched.ddim_step(guided, t_cur, inp["prev_ts"][i], lat)
                continue
            step_noise = (noise[i] if noise is not None else
                          torch.randn(lat.shape, generator=generator, device=lat.device))
            lat, old_pred = sched.dpm_step_scan(guided, old_pred, t_cur, inp["ts_back"][i],
                                                inp["prev_ts"][i], lat, i > 0, step_noise)
        if return_routing:
            return lat, torch.stack(routing) if routing else None
        return lat

    @torch.inference_mode()
    def generate(self, prompt_embeds: torch.Tensor, negative_prompt_embeds: torch.Tensor,
                 image: torch.Tensor, generator: torch.Generator,
                 image_bg: Optional[torch.Tensor] = None, decode: bool = True,
                 return_routing: bool = False, latents: Optional[torch.Tensor] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None,
                 timings: Optional[Dict[str, float]] = None, **cond):
        """prepare latents -> denoise -> decode: video [B, T, 3, H, W] in
        [-1, 1] (or latents with decode=False); the decode takes the whole
        clip at once, as JAX's does (chunked decode: `vae.decode_stream`).
        With `return_routing`, (video, routing) as `denoise` gives it.
        Conditioning kwargs as in `denoise`.  With a `timings` dict, the
        wall time of each stage (encode_s, denoise_s, decode_s), measured
        after a device sync, is stored in it."""
        clock = _StageClock(image.device, timings)
        t_lat = (self.cfg.num_frames - 1) // self.dit.cfg.temporal_compression_ratio + 1
        img_lat = self.prepare_image_latents(image, t_lat)
        bg_lat = None
        n_blocks = self.dit.cfg.in_channels // self.vae.cfg.latent_channels
        if image_bg is not None:
            if n_blocks < 3:
                raise ValueError(f"image_bg given but DiT in_channels={self.dit.cfg.in_channels} "
                                 f"has no bg latent block")
            bg_lat = self.prepare_image_latents(image_bg, t_lat)
        elif n_blocks >= 3:
            bg_lat = torch.zeros_like(img_lat)
        clock.stage("encode_s")
        pe = torch.cat([negative_prompt_embeds, prompt_embeds], dim=0)
        out = self.denoise(pe, img_lat, generator, bg_latents=bg_lat, latents=latents,
                           noise=noise, return_routing=return_routing, **cond)
        lat, routing = out if return_routing else (out, None)
        clock.stage("denoise_s")
        video = lat
        if decode:
            video = self.vae.decode(lat)
            clock.stage("decode_s")
        return (video, routing) if return_routing else video


class _StageClock:
    """Wall time per stage, synchronising the device at each stage end."""

    def __init__(self, device: torch.device, out: Optional[Dict[str, float]]):
        self.device, self.out = device, out
        self.t = time.perf_counter()

    def stage(self, name: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now
