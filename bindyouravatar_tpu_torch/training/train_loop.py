"""The training driver (port of the JAX package's `training/train_loop.py`).

A host loop around `Trainer.train_step`: prefetched batches -> VAE encode
-> teacher masks -> step -> metrics -> checkpoint (with rotation) and the
sub-module export -> auto-resume.  The driver lives on one device; its
batch tensors are made there.

Where it differs from the JAX driver, on purpose:
* Exact resume.  The checkpoint holds the sampler state of the last batch
  consumed (the JAX driver saves its prefetch worker's, up to three
  batches ahead), the numpy generator's state (JAX reseeds it with
  `seed + step`) and the step generator's (JAX restarts its key at
  `seed`): a run stopped and resumed takes the same draws and data as one
  that was not.
* The background latents.  A DiT whose `in_channels` is three times its
  `out_channels` (the 5B configuration: noise, image and background
  latents) gets `bg_latents` of zeros, the pipeline's convention; the JAX
  driver builds none, and its 5B step then fails on the patch embed's
  shape.
Under a mesh (the trainer built with one: `--fsdp` under `torchrun`) every
rank prepares the whole global batch from the same generators and keeps its
rows (`parallel.mesh.local_batch`), so the step equals one rank's; rank 0
writes the metrics, the checkpoints (whole tensors, gathered) and the
sub-module files.
The numpy generator is used in the JAX driver's order (each stochastic
encode's seed, the image noise, each sample's teacher masks), so the masks
and the noised image equal JAX's from the same seed; only the VAE's own
draws (from a `torch.Generator` seeded from that stream) differ.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..models.vae import CausalVAE
from ..utils.masks import (index_mask_to_routing, masks_to_index_mask, noisy_teacher_routing,
                           resize_mask_trilinear)
from ..parallel.mesh import local_batch
from .checkpoint import (SUBMODULE_KEYS, checkpoint_bytes, latest_step, restore_checkpoint,
                         save_checkpoint, save_submodules)
from .data import PrefetchLoader, ResumableSampler
from .trainer import Trainer, TrainState


class MetricsLogger:
    """Rows of scalars to `metrics.jsonl`; to tensorboard too where
    `tensorboardX` imports (the reference logs the same per-step
    scalars)."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter

            self.tb = SummaryWriter(os.path.join(out_dir, "tb"))
        except Exception:
            pass

    def log(self, step: int, metrics: Dict[str, Any]):
        row = {"step": step}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self.tb:
            for k, v in row.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)


def noised_conditioning_image(image: np.ndarray, dense_mask_first: Optional[np.ndarray],
                              rng: np.random.Generator, mean: float = -1.0,
                              std: float = 0.5) -> np.ndarray:
    """Reference `process_image` (train.py:1057-1079): the conditioning
    frame [B, 1, 3, H, W] gets `randn * exp(N(mean, std))` noise, gated by
    the first frame's dense mask [B, H, W] (None: everywhere, the
    reference's mean = -3 variant), before the VAE encode."""
    b = image.shape[0]
    sigma = np.exp(rng.normal(mean, std, size=(b, 1, 1, 1, 1)))
    noise = rng.standard_normal(image.shape) * sigma
    if dense_mask_first is not None:
        noise = noise * dense_mask_first[:, None, None]
    return (image + noise).astype(np.float32)


@dataclasses.dataclass
class TrainDriver:
    """`trainer`'s DiT and `vae` must be on `device` (the card unless the
    caller asks for the CPU).  `text_encode_fn` / `face_embed_fn` map a
    sample's prompts / face crops to embeddings when the caller passes
    none."""
    trainer: Trainer
    vae: Optional[CausalVAE]
    cfg: TrainConfig
    output_dir: str
    device: Any = "cuda"
    text_encode_fn: Optional[Callable[[list], np.ndarray]] = None
    face_embed_fn: Optional[Callable[[np.ndarray], Dict[str, np.ndarray]]] = None
    mute_embeds: Optional[np.ndarray] = None
    step_warn_seconds: float = 300.0

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the driver runs on the card unless given "
                               "device='cpu'")
        for module in (self.trainer.dit, self.vae):
            p = None if module is None else next(module.parameters())
            if p is not None and p.device.type != self.device.type:
                raise ValueError(f"a model is on {p.device}, the driver on {self.device}")
        self.checkpoint_log: List[Dict[str, float]] = []

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def prepare_batch(self, sample: Dict[str, Any], rng: np.random.Generator,
                      text_embeds: Optional[np.ndarray] = None,
                      id_cond: Optional[np.ndarray] = None,
                      id_vit_hidden: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """A collated host sample -> the batch of `Trainer.train_step` on
        the driver's device: the clips and their first frames encoded (one
        sample at a time: the loader's batch is batch_size x accumulation,
        and a whole-batch encode would scale the peak with accumulation),
        the teacher routings and the dense mask at latent resolution."""
        d = self.trainer.dit.cfg
        cfg = self.cfg
        b = sample["video"].shape[0]
        if self.vae is not None:
            def enc(x):
                gen = None
                if cfg.stochastic_vae:        # one seed per encode, drawn in JAX's order
                    gen = torch.Generator(self.device).manual_seed(int(rng.integers(2**31 - 1)))
                with torch.no_grad():
                    return self.vae.encode(x, sample=cfg.stochastic_vae, generator=gen)

            video = self._tensor(sample["video"])
            video_lat = torch.cat([enc(video[i:i + 1]) for i in range(b)])
            del video
            image = np.asarray(sample["video"][:, :1], np.float32)
            if cfg.image_noise:
                dm_first = np.stack([np.asarray(sample["dense_mask"][i][0], np.float32)
                                     for i in range(b)])
                image = noised_conditioning_image(image, dm_first, rng,
                                                  mean=cfg.image_noise_mean,
                                                  std=cfg.image_noise_std)
            image_lat = enc(self._tensor(image))
            pad = image_lat.new_zeros((b, video_lat.shape[1] - 1) + image_lat.shape[2:])
            image_lat = torch.cat([image_lat, pad], dim=1)
        else:   # latents given directly
            video_lat = self._tensor(sample["video_latents"])
            image_lat = self._tensor(sample["image_latents"])

        t_lat, lat_h, lat_w = video_lat.shape[1], video_lat.shape[3], video_lat.shape[4]
        gh, gw = lat_h // d.patch_size, lat_w // d.patch_size
        teacher_clean, teacher_noisy, dense_lat = [], [], []
        for i in range(b):
            masks = sample["masks"][i]                    # [I, T_px, H, W]
            idx = masks_to_index_mask(masks[0], masks[1], t_lat, gh, gw)
            clean = index_mask_to_routing(idx, d.num_ids)[0]
            clean = clean.reshape(t_lat, gh, gw, d.num_ids).max(0, keepdims=True)
            teacher_clean.append(np.broadcast_to(clean, (t_lat, gh, gw, d.num_ids))
                                 .reshape(-1, d.num_ids))
            teacher_noisy.append(noisy_teacher_routing(idx, (t_lat, gh, gw), rng, d.num_ids))
            dense_lat.append(resize_mask_trilinear(sample["dense_mask"][i], t_lat, lat_h, lat_w))

        if text_embeds is None:
            if self.text_encode_fn is None:
                raise ValueError("need text_embeds or text_encode_fn")
            text_embeds = self.text_encode_fn(sample["prompt"])
        if id_cond is None and self.face_embed_fn is not None:
            emb = self.face_embed_fn(sample["face_crops"])
            id_cond, id_vit_hidden = emb["id_cond"], emb["id_vit_hidden"]
        audio = sample["audio"]
        batch = dict(
            video_latents=video_lat, image_latents=image_lat,
            prompt_embeds=self._tensor(text_embeds),
            teacher_clean=self._tensor(np.stack(teacher_clean)),
            teacher_noisy=self._tensor(np.stack(teacher_noisy)),
            dense_mask=self._tensor(np.stack(dense_lat)),
            af_matrix=self._tensor(sample["af_matrix"]),
            audio_embeds=self._tensor(audio) if audio.size else None,
            mute_embeds=None if self.mute_embeds is None else self._tensor(self.mute_embeds))
        if d.in_channels == 3 * d.out_channels:   # no dataset carries a background frame
            batch["bg_latents"] = torch.zeros_like(video_lat)
        if id_cond is not None:
            batch["id_cond"] = self._tensor(id_cond)
            batch["id_vit_hidden"] = self._tensor(id_vit_hidden)
        return batch

    def host_state(self) -> Dict[str, Any]:
        """The host side of the run's state as of the last step: the
        sampler state of the last consumed batch and both generators'."""
        return {"sampler": self._loader_state, "np_rng": self._rng_np.bit_generator.state,
                "torch_rng": self._gen.get_state()}

    @property
    def lead(self) -> bool:
        """Whether this process writes (rank 0, or the only one)."""
        return self.trainer.mesh is None or torch.distributed.get_rank() == 0

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a prepared global batch (the batch itself
        without a mesh)."""
        tr = self.trainer
        if tr.mesh is None:
            return batch
        accum = max(1, int(self.cfg.grad_accum_steps))
        return {k: v if v is None or k == "mute_embeds"
                else local_batch(v, tr.batch_index, tr.batch_count, accum)
                for k, v in batch.items()}

    def _checkpoint(self, ckpt_dir: str, step: int, state: TrainState):
        t0 = time.perf_counter()
        payload = {"state": self.trainer.state_dict(state), **self.host_state()}
        named = self.trainer.named_tensors(
            state, [p for ps in SUBMODULE_KEYS.values() for p in ps])
        if not self.lead:
            torch.distributed.barrier()
            return
        path = save_checkpoint(ckpt_dir, step, payload,
                               total_limit=self.cfg.checkpoints_total_limit)
        seconds = time.perf_counter() - t0
        modules = os.path.join(self.output_dir, f"modules-{step}")
        t0 = time.perf_counter()
        save_submodules(named, modules)
        entry = dict(event="save", step=step, bytes=checkpoint_bytes(path), seconds=seconds,
                     modules_bytes=checkpoint_bytes(modules),
                     modules_seconds=time.perf_counter() - t0)
        self.checkpoint_log.append(entry)
        print(f"[checkpoint] step {step}: {entry['bytes'] / 1e9:.3f} GB in {seconds:.2f} s "
              f"(+ sub-modules {entry['modules_bytes'] / 1e9:.3f} GB in "
              f"{entry['modules_seconds']:.2f} s)", flush=True)
        if self.trainer.mesh is not None:
            torch.distributed.barrier()

    def _restore(self, ckpt_dir: str, state: TrainState, sampler: ResumableSampler) -> TrainState:
        t0 = time.perf_counter()
        step = latest_step(ckpt_dir)
        payload = restore_checkpoint(ckpt_dir, step)
        state = self.trainer.load_state_dict(payload["state"], state)
        sampler.load_state_dict(payload["sampler"])
        self._loader_state = sampler.state_dict()
        self._rng_np.bit_generator.state = payload["np_rng"]
        self._gen.set_state(payload["torch_rng"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        self.checkpoint_log.append(dict(event="restore", step=step, seconds=seconds,
                                        bytes=checkpoint_bytes(os.path.join(ckpt_dir, str(step)))))
        # the learning rate is not part of the state: the configured schedule
        # applies over the restored moments (reference train.py:909-921)
        print(f"[resume] restored step {step} in {seconds:.2f} s; applying "
              f"learning_rate={self.cfg.learning_rate} over the restored optimizer state",
              flush=True)
        return state

    def _measured(self, fn):
        """(fn(), wall seconds to the device's end of it, peak GiB of device
        memory during it or None on the CPU)."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        return out, seconds, (torch.cuda.max_memory_allocated(self.device) / 2**30
                              if cuda else None)

    def run(self, dataset, batch_size: int = 1, max_steps: Optional[int] = None,
            resume: Optional[str] = "latest", make_batch_extras: Optional[Callable] = None,
            validation_fn: Optional[Callable] = None,
            resume_fn: Optional[Callable[["TrainDriver", TrainState], None]] = None
            ) -> TrainState:
        """Train up to `max_steps` (default `cfg.max_train_steps`) optimizer
        steps of `batch_size x grad_accum_steps` samples.  `resume`:
        "latest" continues from the newest checkpoint under
        `{output_dir}/checkpoints` if there is one; None or "none" starts
        afresh.  `resume_fn(driver, state)` is called after a restore."""
        if resume not in (None, "none", "latest"):
            raise ValueError(f"resume={resume!r}: 'latest' or None")
        cfg = self.cfg
        os.makedirs(self.output_dir, exist_ok=True)
        logger = MetricsLogger(self.output_dir) if self.lead else None
        ckpt_dir = os.path.join(self.output_dir, "checkpoints")
        state = self.trainer.init_state()
        sampler = ResumableSampler(len(dataset), shuffle=True, seed=cfg.seed)
        self._loader_state = sampler.state_dict()
        self._rng_np = np.random.default_rng(cfg.seed)
        self._gen = torch.Generator(self.device).manual_seed(cfg.seed)
        if resume == "latest" and latest_step(ckpt_dir) is not None:
            state = self._restore(ckpt_dir, state, sampler)
            if resume_fn is not None:
                resume_fn(self, state)

        loader = PrefetchLoader(dataset, sampler, batch_size * max(1, cfg.grad_accum_steps))
        total = max_steps or cfg.max_train_steps
        try:
            while state.step < total:
                sample = next(loader)
                self._loader_state = loader.state_dict()
                extras = make_batch_extras(sample) if make_batch_extras else {}
                batch, prep_s, prep_peak = self._measured(
                    lambda: self.local_batch(self.prepare_batch(sample, self._rng_np, **extras)))
                (state, metrics), dt, step_peak = self._measured(
                    lambda: self.trainer.train_step(state, batch, generator=self._gen))
                del batch
                if dt > self.step_warn_seconds:
                    print(f"[watchdog] step {state.step - 1} took {dt:.0f}s "
                          f"(> {self.step_warn_seconds:.0f}s)", flush=True)
                metrics.update(step_time_s=dt, prepare_batch_s=prep_s)
                if prep_peak is not None:
                    metrics.update(prepare_batch_peak_gib=prep_peak, step_peak_gib=step_peak)
                if logger is not None:
                    logger.log(state.step, metrics)
                if state.step % cfg.checkpointing_steps == 0 or state.step >= total:
                    self._checkpoint(ckpt_dir, state.step, state)
                    if validation_fn is not None:
                        validation_fn(state.step, self.trainer.model_named(state))
        finally:
            loader.close()
        return state
