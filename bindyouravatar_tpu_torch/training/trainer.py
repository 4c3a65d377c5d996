"""Stage-3 trainer in torch (port of `bindyouravatar_tpu/training/trainer.py`).

One optimizer step: the batch's leading axis is `grad_accum_steps` micro-
batches; each runs `loss_and_metrics` forward and backward (gradients flow
only into the trainable partition, the sft unfreeze list plus LoRA), the
gradients and metrics are averaged, clipped by their global norm (optax's
formula), and AdamW (optax's update, weight decay and eps placement) moves
the trainable parameters in place under the warmup + cosine schedule.

Randomness: every draw of the JAX step (timestep, noise, the image /
background / teacher-mask dropout keeps, the mask-loss coin and the mute
tokens' dropout mask) comes out of `Trainer.draw`, from an explicit
`torch.Generator`; `loss_and_metrics` and `train_step` also take the draws
ready-made, which is how the tests feed the port JAX's own draws.

With `is_diff_lr` the perceivers (names starting with `perceiver`) step at
`lr * diff_lr_high` and every other trainable tensor at `lr * diff_lr_low`,
weight decay scaled with them (JAX's `optax.multi_transform` of two AdamWs
under one clip).  With `ema_decay` an EMA copy of the trainable tensors
follows each update.  Not ported: adafactor, prodigy and 8-bit Adam; the
trainer raises on them.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Optional, Sequence

import torch

from ..config import TrainConfig
from ..models.audio import mute_dropout_keep
from ..models.dit import DiT
from ..ops.scheduler import Schedule
from . import losses as L

# Trainable parameter-name patterns: sft.sh's unfreeze list (the mute
# tokens, the perceivers, the router, the audio layers) plus LoRA, in the
# port's names (the JAX package's `DEFAULT_TRAINABLE_PATTERNS` converted).
DEFAULT_TRAINABLE_PATTERNS = (
    r".*lora_[AB].*",
    r"^perceivers\.",
    r"^router_norms\.",
    r"^router_layers\.",
    r"^router_trunk\.",
    r"^audio_layers\.",
    r"^audio_statics\.mute_learnable_tokens$",
)


def partition_params(named: Mapping[str, torch.Tensor],
                     patterns: Sequence[str] = DEFAULT_TRAINABLE_PATTERNS):
    """Split name -> tensor into (trainable, frozen) by name regex."""
    regs = [re.compile(p) for p in patterns]
    train = {k: v for k, v in named.items() if any(r.match(k) for r in regs)}
    frozen = {k: v for k, v in named.items() if k not in train}
    return train, frozen


def merge_params(trainable: Mapping[str, torch.Tensor],
                 frozen: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {**frozen, **trainable}


def make_lr_schedule(cfg: TrainConfig):
    """count -> learning rate: optax's `join_schedules` of a linear warmup
    from 0 over `lr_warmup_steps` and `lr_num_cycles` cosine decays to 0
    ("cosine_with_restarts"), or the constant rate."""
    lr = cfg.learning_rate
    if cfg.lr_scheduler == "constant":
        return lambda count: lr
    if cfg.lr_scheduler != "cosine_with_restarts":
        raise ValueError(cfg.lr_scheduler)
    warm = cfg.lr_warmup_steps
    decay = max(1, (cfg.max_train_steps - warm) // cfg.lr_num_cycles)
    bounds = [warm + i * decay for i in range(cfg.lr_num_cycles)]

    def sched(count: int) -> float:
        # optax's linear_schedule with no transition steps is the constant 0
        value = lr * min(max(count, 0), warm) / warm if warm > 0 else 0.0
        for b in bounds:
            if count >= b:
                c = min(count - b, decay)
                value = lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return value

    return sched


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@dataclasses.dataclass
class TrainState:
    """The step count, AdamW's state (optax `ScaleByAdamState`: the count
    and the first and second moments of each trainable tensor) and the EMA
    copy of the trainable tensors when `ema_decay` is set.  The trainable
    tensors themselves are the model's."""
    step: int
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]] = None


class Trainer:
    """Train step over a `DiT` whose parameters it updates in place."""

    def __init__(self, dit: DiT, schedule: Schedule, cfg: TrainConfig = TrainConfig(),
                 trainable_patterns: Sequence[str] = DEFAULT_TRAINABLE_PATTERNS):
        if cfg.optimizer != "adamw" or cfg.use_8bit_adam:
            raise NotImplementedError("the port's trainer runs AdamW (adafactor, prodigy and "
                                      "8-bit AdamW: ROADMAP.md A 5)")
        self.dit, self.schedule, self.cfg = dit, schedule, cfg
        self.trainable, self.frozen = partition_params(dict(dit.named_parameters()),
                                                       trainable_patterns)
        self.lr = make_lr_schedule(cfg)

    def lr_mult(self, name: str) -> float:
        """The learning-rate factor of a trainable tensor (`is_diff_lr`)."""
        if not self.cfg.is_diff_lr:
            return 1.0
        return self.cfg.diff_lr_high if name.startswith("perceiver") else self.cfg.diff_lr_low

    def init_state(self) -> TrainState:
        """Mark the trainable partition (only it takes gradients), zero
        AdamW's moments and copy the EMA's start (with `ema_decay`)."""
        for p in self.frozen.values():
            p.requires_grad_(False)
        for p in self.trainable.values():
            p.requires_grad_(True)
        zeros = lambda: {k: torch.zeros_like(p) for k, p in self.trainable.items()}
        ema = ({k: p.detach().clone() for k, p in self.trainable.items()}
               if self.cfg.ema_decay else None)
        return TrainState(step=0, count=0, mu=zeros(), nu=zeros(), ema=ema)

    def state_dict(self, state: TrainState) -> Dict[str, object]:
        """What a checkpoint holds of the training state: the step, AdamW's
        count and moments, the trainable tensors and the EMA copy."""
        return {"step": state.step, "count": state.count,
                "params": {k: p.detach() for k, p in self.trainable.items()},
                "mu": state.mu, "nu": state.nu, "ema": state.ema}

    @torch.no_grad()
    def load_state_dict(self, saved: Mapping[str, object], state: TrainState) -> TrainState:
        """Copy a `state_dict` (tensors on any device) into the model's
        trainable tensors and into `state`'s tensors (as `init_state` made
        them); raise unless the names and shapes are the trainable set's."""
        params = saved["params"]
        if set(params) != set(self.trainable) or (saved["ema"] is None) != (state.ema is None):
            raise ValueError("the checkpoint's trainable set (or its EMA) is not this "
                             "trainer's")
        for name, dst in (("params", self.trainable), ("mu", state.mu), ("nu", state.nu),
                          ("ema", state.ema)):
            for k, t in (dst or {}).items():
                t.copy_(saved[name][k])
        return TrainState(step=int(saved["step"]), count=int(saved["count"]), mu=state.mu,
                          nu=state.nu, ema=state.ema)

    # ------------------------------------------------------------------ #
    def draw(self, batch: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The random draws of one micro-batch's loss (JAX `trainer.py:189-235`
        and the mute tokens' dropout): timesteps, noise, the conditioning
        dropout keeps, the mask-loss coin, the dropout keep mask."""
        c = self.cfg
        v = batch["video_latents"]
        b, dev = v.shape[0], v.device
        t = torch.randint(0, self.schedule.config.num_train_timesteps, (b,),
                          generator=generator, device=dev)
        noise = torch.randn(v.shape, generator=generator, device=dev)
        coins = torch.rand(3 * b + 1, generator=generator, device=dev)   # one uniform draw
        return dict(
            t=t, noise=noise,
            keep_img=(coins[:b] >= c.noised_image_dropout).reshape(b, 1, 1, 1, 1),
            keep_bg=(coins[b:2 * b] >= c.drop_inpaint_prob).reshape(b, 1, 1, 1, 1),
            keep_mask=(coins[2 * b:3 * b] >= c.index_mask_drop_prob).reshape(b, 1, 1),
            use_mask_loss=coins[3 * b] < c.mask_prob,
            dropout_keep=mute_dropout_keep(self.dit.audio_cfg, dev, generator))

    def loss_and_metrics(self, batch: Mapping[str, torch.Tensor],
                         draws: Optional[Mapping[str, torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None):
        """(total loss, metrics) of one micro-batch: the noised latents
        through `DiT.apply` (teacher-forced routing, dropout on), the
        v-prediction loss (optionally masked) and the six routing losses."""
        c, d, sch = self.cfg, self.dit.cfg, self.schedule
        if draws is None:
            draws = self.draw(batch, generator)
        video = batch["video_latents"]
        grid = (video.shape[1], video.shape[3] // d.patch_size, video.shape[4] // d.patch_size)
        t = draws["t"]
        noisy = sch.add_noise(video, draws["noise"], t)
        chans = [noisy.to(video.dtype), batch["image_latents"] * draws["keep_img"]]
        if batch.get("bg_latents") is not None:
            chans.append(batch["bg_latents"] * draws["keep_bg"])
        teacher_noisy = batch.get("teacher_noisy")
        if teacher_noisy is not None:
            teacher_noisy = teacher_noisy * draws["keep_mask"]
        rope = self.dit.rope(video.shape[3] * 8, video.shape[4] * 8, video.shape[1],
                             device=video.device)
        out, routing = self.dit.apply(
            torch.cat(chans, dim=2), batch["prompt_embeds"], t.float(), rope,
            id_cond=batch.get("id_cond"), id_vit_hidden=batch.get("id_vit_hidden"),
            audio_embeds=batch.get("audio_embeds"), mute_embeds=batch.get("mute_embeds"),
            af_matrix=batch.get("af_matrix"), routing_override=teacher_noisy,
            deterministic=False, dropout_keep=draws["dropout_keep"])

        dense = None
        if c.enable_mask_loss and batch.get("dense_mask") is not None:
            m = batch["dense_mask"]
            dense = torch.where(draws["use_mask_loss"], m, torch.ones_like(m))
        d_loss = L.diffusion_loss(out, noisy, video, t, sch, dense)
        metrics = {"diffusion_loss": d_loss}
        total = d_loss
        teacher = batch.get("teacher_clean")
        if routing is not None and teacher is not None:
            ct = c.compat_transposed_grid_losses
            parts = dict(router_loss=(c.router_loss_weight, L.routing_bce_loss(routing, teacher)),
                         consistency_loss=(c.consistency_loss_weight, L.consistency_loss(routing)),
                         temporal_diff_loss=(c.temporal_diff_loss_weight,
                                             L.temporal_diff_loss(routing, grid, ct)),
                         spatial_diff_loss=(c.spatial_diff_loss_weight,
                                            L.spatial_diff_loss(routing, grid, ct)),
                         spatial_dist_loss=(c.spatial_dist_loss_weight,
                                            L.spatial_distribution_loss(routing, grid, ct)),
                         id_dist_loss=(c.id_dist_loss_weight,
                                       L.id_distribution_loss(routing, grid, ct)))
            for name, (weight, value) in parts.items():
                total = total + weight * value
                metrics[name] = value
        metrics["loss"] = total
        return total, metrics

    def grads_and_metrics(self, batch: Mapping[str, torch.Tensor],
                          draws: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
                          generator: Optional[torch.Generator] = None):
        """Mean gradients (name -> tensor, zeros where none flowed) and mean
        metrics over `grad_accum_steps` micro-batches: the batch's leading
        axis split in order, `mute_embeds` (no batch axis) shared, and
        `draws[i]` (if given) for micro-batch i."""
        accum = max(1, int(self.cfg.grad_accum_steps))
        for p in self.trainable.values():
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            mb = {}
            for k, v in batch.items():
                if v is None or k == "mute_embeds":
                    mb[k] = v
                else:
                    if v.shape[0] % accum:
                        raise ValueError(f"batch size {v.shape[0]} not divisible by "
                                         f"grad_accum_steps={accum}")
                    n = v.shape[0] // accum
                    mb[k] = v[i * n:(i + 1) * n]
            loss, metrics = self.loss_and_metrics(
                mb, None if draws is None else draws[i], generator)
            loss.backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        grads = {}
        for k, p in self.trainable.items():       # the summed .grad becomes the mean
            grads[k] = (torch.zeros_like(p) if p.grad is None else p.grad).div_(accum)
            p.grad = None
        return grads, {k: v / accum for k, v in sums.items()}

    @torch.no_grad()
    def apply_gradients(self, state: TrainState,
                        grads: Mapping[str, torch.Tensor]) -> TrainState:
        """optax.chain(clip_by_global_norm, adamw) on the trainable tensors,
        in place (the gradients are clipped in place too): mu/nu moments,
        bias correction, the update mu_hat / (sqrt(nu_hat) + eps) plus
        weight decay, times -lr(count) (and the tensor's `lr_mult`); then
        the EMA, ema = d * ema + (1 - d) * p."""
        c = self.cfg
        g_norm = global_norm(grads.values())
        if not bool(g_norm < c.max_grad_norm):
            for g in grads.values():
                g.div_(g_norm).mul_(c.max_grad_norm)
        lr, count = self.lr(state.count), state.count + 1
        b1, b2 = c.adam_beta1, c.adam_beta2
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        for k, p in self.trainable.items():
            g, mu, nu = grads[k].float(), state.mu[k], state.nu[k]
            mu.mul_(b1).add_((1.0 - b1) * g)
            nu.mul_(b2).add_(g.square().mul_(1.0 - b2))
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + c.adam_epsilon)
            update.add_(p.float(), alpha=c.weight_decay)
            p.add_((-lr * self.lr_mult(k) * update).to(p.dtype))
        if state.ema is not None:
            d = c.ema_decay
            for k, e in state.ema.items():
                e.mul_(d).add_(self.trainable[k], alpha=1.0 - d)
        return TrainState(step=state.step + 1, count=count, mu=state.mu, nu=state.nu,
                          ema=state.ema)

    def train_step(self, state: TrainState, batch: Mapping[str, torch.Tensor],
                   draws: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
                   generator: Optional[torch.Generator] = None):
        """One optimizer step -> (new state, metrics with `grad_norm`, the
        global norm of the mean gradients before clipping)."""
        grads, metrics = self.grads_and_metrics(batch, draws, generator)
        metrics["grad_norm"] = global_norm(grads.values())
        return self.apply_gradients(state, grads), metrics
