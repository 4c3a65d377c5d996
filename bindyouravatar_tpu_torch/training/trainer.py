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

The optimizer is `cfg.optimizer`, as JAX's `make_optimizer` builds it:
"adamw" (optax's AdamW, or with `use_8bit_adam` the block-wise 8-bit AdamW
of `adam8bit.py`), "adafactor" (`optax.adafactor(lr)`, `adafactor.py`) or
"prodigy" (`prodigy.py`).  `use_8bit_adam` with another optimizer raises:
JAX reads the flag only under AdamW and silently runs the full-precision
optimizer instead.  With `is_diff_lr` the perceivers (names starting with
`perceiver`) form the group "high", stepping at `lr * diff_lr_high`, and
every other trainable tensor the group "low" at `lr * diff_lr_low` (JAX's
`optax.multi_transform` of one optimizer per group under one clip: prodigy
keeps its scalars per group); otherwise one group, "all".  With `ema_decay`
an EMA copy of the trainable tensors follows each update.

Under a (dp, fsdp) mesh every optimizer steps on each rank's parts of the
sharded tensors and sums over the fsdp group the statistics that span a
split (`shards.py`); a checkpoint holds every tensor of the state whole.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..config import TrainConfig
from ..models.audio import mute_dropout_keep
from ..models.dit import DiT
from ..ops.scheduler import Schedule
from ..parallel.sharding import Part, gather_part, local, narrow_part, param_part
from . import losses as L
from .adafactor import Adafactor
from .adam8bit import AdamW8bit
from .prodigy import Prodigy
from .shards import ShardAware

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


class AdamW(ShardAware):
    """optax's AdamW: mu/nu moments, bias correction, the update
    mu_hat / (sqrt(nu_hat) + eps) plus weight decay, times -lr.  State
    `mu`, `nu` (fp32 like each tensor; elementwise, so a rank's parts need
    no collective)."""

    PARAM_LIKE = ("mu", "nu")

    def __init__(self, b1: float, b2: float, eps: float, weight_decay: float):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params: Mapping[str, torch.Tensor], groups=None):
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return {"mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def step(self, params, grads, state, groups, lrs, count: int) -> None:
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
        for label, names in groups.items():
            for k in names:
                p, g, mu, nu = params[k], grads[k].float(), state["mu"][k], state["nu"][k]
                mu.mul_(b1).add_((1.0 - b1) * g)
                nu.mul_(b2).add_(g.square().mul_(1.0 - b2))
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                update.add_(p.float(), alpha=self.wd)
                p.add_((-lrs[label] * update).to(p.dtype))


def make_optimizer(cfg: TrainConfig):
    """The optimizer of `cfg` (JAX `trainer.py:_base_opt`)."""
    if cfg.use_8bit_adam and cfg.optimizer != "adamw":
        raise ValueError(f"use_8bit_adam is AdamW's option, not {cfg.optimizer!r}'s (the JAX "
                         "trainer ignores it there and runs the full-precision optimizer)")
    if cfg.optimizer == "adamw":
        cls = AdamW8bit if cfg.use_8bit_adam else AdamW
        return cls(cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon, cfg.weight_decay)
    if cfg.optimizer == "adafactor":
        return Adafactor()
    if cfg.optimizer == "prodigy":
        return Prodigy(cfg.adam_beta1, cfg.adam_beta2, beta3=cfg.prodigy_beta3,
                       eps=cfg.adam_epsilon, weight_decay=cfg.weight_decay,
                       decouple=cfg.prodigy_decouple,
                       use_bias_correction=cfg.prodigy_use_bias_correction,
                       safeguard_warmup=cfg.prodigy_safeguard_warmup)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


@dataclasses.dataclass
class TrainState:
    """The step count, the optimizer's update count and state (`opt`: its
    kinds of state by name, each name -> tensor, or label -> scalar tensor
    for prodigy's per-group scalars; AdamW's are `mu` and `nu`, optax's
    `ScaleByAdamState` moments) and the EMA copy of the trainable tensors
    when `ema_decay` is set.  The trainable tensors themselves are the
    model's."""
    step: int
    count: int
    opt: Dict[str, Dict[str, torch.Tensor]]
    ema: Optional[Dict[str, torch.Tensor]] = None


class Trainer:
    """Train step over a `DiT` whose parameters it updates in place."""

    def __init__(self, dit: DiT, schedule: Schedule, cfg: TrainConfig = TrainConfig(),
                 trainable_patterns: Sequence[str] = DEFAULT_TRAINABLE_PATTERNS, mesh=None):
        self.optimizer = make_optimizer(cfg)
        self.dit, self.schedule, self.cfg, self.mesh = dit, schedule, cfg, mesh
        self.trainable, self.frozen = partition_params(dict(dit.named_parameters()),
                                                       trainable_patterns)
        self.parts: Dict[str, Part] = {}
        if mesh is not None:
            self._shard(mesh, trainable_patterns)
        self.lr = make_lr_schedule(cfg)
        names = list(self.trainable)
        # the LR groups (label -> tensor names) and each one's factor of the
        # learning rate: `is_diff_lr` gives the perceivers their own
        if cfg.is_diff_lr:
            self.groups = {"high": [k for k in names if k.startswith("perceiver")],
                           "low": [k for k in names if not k.startswith("perceiver")]}
            self.lr_factors = {"high": cfg.diff_lr_high, "low": cfg.diff_lr_low}
        else:
            self.groups = {"all": names}
            self.lr_factors = {"all": 1.0}

    def _shard(self, mesh, trainable_patterns) -> None:
        """Place the DiT over `mesh`'s (dp, fsdp) axes (`parallel.sharding.
        shard_params`, the trainable and the frozen tensors alike, as JAX's
        `init_state(mesh=...)`); the optimizer then works on each rank's
        parts, summing over the fsdp group what spans a split (`shards.py`).
        Each rank's batch is its slice of the global batch
        (`mesh.local_batch`), the draws are made for the global batch and
        sliced, the gradients of the replicated tensors and the metrics are
        averaged over the ranks, and the clip takes the global norm."""
        from ..parallel import sharding
        from ..parallel.mesh import AXIS_FSDP, AXIS_TENSOR, batch_rank

        if mesh[AXIS_TENSOR].size() != 1:
            raise ValueError("the trainer shards over dp x fsdp; tp is inference only")
        for p in self.frozen.values():          # before sharding: FSDP reads the flags
            p.requires_grad_(False)
        for p in self.trainable.values():
            p.requires_grad_(True)
        sharding.shard_params(self.dit, mesh)
        self.trainable, self.frozen = partition_params(dict(self.dit.named_parameters()),
                                                       trainable_patterns)
        self.batch_index, self.batch_count = batch_rank(mesh)
        self.fsdp_group = mesh[AXIS_FSDP].get_group()
        self.parts = {k: part for k, p in self.trainable.items()
                      if (part := param_part(p)) is not None}
        self.optimizer.shard(self.parts, self.fsdp_group)

    @staticmethod
    def _local(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: local(p) for k, p in params.items()}

    def init_state(self) -> TrainState:
        """Mark the trainable partition (only it takes gradients), start the
        optimizer's state and copy the EMA's start (with `ema_decay`); under
        a mesh both hold this rank's parts."""
        for p in self.frozen.values():
            p.requires_grad_(False)
        for p in self.trainable.values():
            p.requires_grad_(True)
        params = self._local(self.trainable)
        with torch.no_grad():
            opt = self.optimizer.init(params, self.groups)
        ema = ({k: p.detach().clone() for k, p in params.items()}
               if self.cfg.ema_decay else None)
        return TrainState(step=0, count=0, opt=opt, ema=ema)

    def _part(self, kind: str, name: str) -> Optional[Part]:
        """Where this rank's tensor `name` of the state's `kind` ("params",
        "ema" or a kind of optimizer state) is split, or None (whole)."""
        if kind in ("params", "ema"):
            return self.parts.get(name)
        return self.optimizer.state_part(kind, name)

    def _whole(self, t: torch.Tensor, kind: str, name: str) -> torch.Tensor:
        """The whole tensor of this rank's tensor `name` of `kind` (a
        collective under a mesh: every rank calls it)."""
        return gather_part(t, self.trainable.get(name), self._part(kind, name))

    def named_tensors(self, state: TrainState,
                      frozen_prefixes: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Whole tensors by name (a collective under a mesh): the trainable
        ones (their EMA copy when the state keeps one) and the frozen ones
        starting with one of `frozen_prefixes`."""
        src = self._local(self.trainable) if state.ema is None else state.ema
        out = {k: self._whole(t, "params", k) for k, t in src.items()}
        for k, p in self.frozen.items():
            if k.startswith(tuple(frozen_prefixes)):
                out[k] = gather_part(local(p), p, param_part(p))
        return out

    def model_named(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The DiT's tensors by name as the model holds them (its own
        tensors, or the EMA copy in the trainable tensors' layout), for
        `validation.make_validation_fn`."""
        named = merge_params(self.trainable, self.frozen)
        for k, e in (state.ema or {}).items():
            p = self.trainable[k]
            named[k] = (DTensor.from_local(e, p.device_mesh, p.placements, shape=p.shape,
                                           stride=p.stride(), run_check=False)
                        if isinstance(p, DTensor) else e)
        return named

    def state_dict(self, state: TrainState) -> Dict[str, object]:
        """What a checkpoint holds of the training state: the step, the
        optimizer's count and each kind of its state under its own key
        (AdamW's `mu` and `nu`, the format's first layout), the trainable
        tensors and the EMA copy.  Under a mesh every tensor is gathered
        whole (every rank must call it), so a checkpoint does not depend on
        the rank count."""
        whole = lambda kind, ts: {k: self._whole(t, kind, k) for k, t in ts.items()}
        return {"step": state.step, "count": state.count,
                "params": whole("params", {k: p.detach()
                                           for k, p in self._local(self.trainable).items()}),
                **{kind: whole(kind, ts) for kind, ts in state.opt.items()},
                "ema": None if state.ema is None else whole("ema", state.ema)}

    @torch.no_grad()
    def load_state_dict(self, saved: Mapping[str, object], state: TrainState) -> TrainState:
        """Copy a `state_dict` (tensors on any device) into the model's
        trainable tensors and into `state`'s tensors (as `init_state` made
        them; under a mesh this rank's parts of them); raise unless the
        names and shapes are the trainable set's."""
        if set(saved["params"]) != set(self.trainable) or (saved["ema"] is None) != (state.ema is None):
            raise ValueError("the checkpoint's trainable set (or its EMA) is not this "
                             "trainer's")
        if any(set(saved.get(kind, ())) != set(part) for kind, part in state.opt.items()):
            raise ValueError(f"the checkpoint holds no {self.cfg.optimizer} state of this "
                             f"trainer's tensors ({sorted(state.opt)})")
        params = self._local(self.trainable)
        for kind, dst in (("params", params), ("ema", state.ema), *state.opt.items()):
            for k, t in (dst or {}).items():
                part = self._part(kind, k)
                t.copy_(narrow_part(saved[kind][k], part, t.shape[part.dim] if part else 0))
        return TrainState(step=int(saved["step"]), count=int(saved["count"]), opt=state.opt,
                          ema=state.ema)

    # ------------------------------------------------------------------ #
    def draw(self, batch: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The random draws of one micro-batch's loss (JAX `trainer.py:189-235`
        and the mute tokens' dropout): timesteps, noise, the conditioning
        dropout keeps, the mask-loss coin, the dropout keep mask."""
        c = self.cfg
        v = batch["video_latents"]
        n, dev = v.shape[0], v.device
        # under a mesh: drawn for the global micro-batch, this rank's rows kept
        i0, count = (0, 1) if self.mesh is None else (self.batch_index, self.batch_count)
        b = n * count
        rows = slice(i0 * n, (i0 + 1) * n)
        t = torch.randint(0, self.schedule.config.num_train_timesteps, (b,),
                          generator=generator, device=dev)
        noise = torch.randn((b,) + tuple(v.shape[1:]), generator=generator, device=dev)
        coins = torch.rand(3 * b + 1, generator=generator, device=dev)   # one uniform draw
        return dict(
            t=t[rows], noise=noise[rows],
            keep_img=(coins[:b] >= c.noised_image_dropout).reshape(b, 1, 1, 1, 1)[rows],
            keep_bg=(coins[b:2 * b] >= c.drop_inpaint_prob).reshape(b, 1, 1, 1, 1)[rows],
            keep_mask=(coins[2 * b:3 * b] >= c.index_mask_drop_prob).reshape(b, 1, 1)[rows],
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
        out, routing = self.dit(
            torch.cat(chans, dim=2), batch["prompt_embeds"], t.float(), rope,
            id_cond=batch.get("id_cond"), id_vit_hidden=batch.get("id_vit_hidden"),
            audio_embeds=batch.get("audio_embeds"), mute_embeds=batch.get("mute_embeds"),
            af_matrix=batch.get("af_matrix"), routing_override=teacher_noisy,
            deterministic=False, dropout_keep=draws["dropout_keep"])

        dense = None
        if c.enable_mask_loss and batch.get("dense_mask") is not None:
            m = batch["dense_mask"]
            dense = torch.where(draws["use_mask_loss"], m, torch.ones_like(m))
        den = None
        if dense is not None and self.mesh is not None:
            # the masked mean is over the global micro-batch: each rank
            # divides by the whole count (over the ranks, which FSDP averages)
            den = L.mask_count(dense, out.shape)
            dist.all_reduce(den)
            den = den.clamp_min(1.0) / self.batch_count
        d_loss = L.diffusion_loss(out, noisy, video, t, sch, dense, den)
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
            g = torch.zeros_like(local(p)) if p.grad is None else local(p.grad)
            grads[k] = g.div_(accum)
            p.grad = None
        metrics = {k: v / accum for k, v in sums.items()}
        if self.mesh is not None:
            # FSDP averaged the sharded tensors' gradients; average the
            # replicated ones and the metrics over the ranks
            rep = [grads[k] for k, p in self.trainable.items() if not isinstance(p, DTensor)]
            for t in rep + list(metrics.values()):
                dist.all_reduce(t)
                t.div_(self.batch_count)
        return grads, metrics

    def grad_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients (under a mesh: of the whole
        tensors, from each rank's parts)."""
        if self.mesh is None:
            return global_norm(grads.values())
        sharded = {k for k, p in self.trainable.items() if isinstance(p, DTensor)}
        sq = lambda ks: sum(((grads[k].float() ** 2).sum() for k in ks),
                            torch.zeros((), device=next(iter(grads.values())).device))
        part = sq([k for k in grads if k in sharded])
        dist.all_reduce(part, group=self.fsdp_group)
        return torch.sqrt(part + sq([k for k in grads if k not in sharded]))

    @torch.no_grad()
    def apply_gradients(self, state: TrainState,
                        grads: Mapping[str, torch.Tensor]) -> TrainState:
        """optax.chain(clip_by_global_norm, the optimizer) on the trainable
        tensors, in place (the gradients are clipped in place too), each
        group at lr(count) times its factor; then the EMA, ema = d * ema +
        (1 - d) * p."""
        c = self.cfg
        g_norm = self.grad_norm(grads)
        if not bool(g_norm < c.max_grad_norm):
            for g in grads.values():
                g.div_(g_norm).mul_(c.max_grad_norm)
        lr = self.lr(state.count)
        lrs = {label: lr * f for label, f in self.lr_factors.items()}
        params = self._local(self.trainable)
        self.optimizer.step(params, grads, state.opt, self.groups, lrs, state.count)
        if state.ema is not None:
            d = c.ema_decay
            for k, e in state.ema.items():
                e.mul_(d).add_(params[k], alpha=1.0 - d)
        return TrainState(step=state.step + 1, count=state.count + 1, opt=state.opt,
                          ema=state.ema)

    def train_step(self, state: TrainState, batch: Mapping[str, torch.Tensor],
                   draws: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
                   generator: Optional[torch.Generator] = None):
        """One optimizer step -> (new state, metrics with `grad_norm`, the
        global norm of the mean gradients before clipping)."""
        grads, metrics = self.grads_and_metrics(batch, draws, generator)
        metrics["grad_norm"] = self.grad_norm(grads)
        return self.apply_gradients(state, grads), metrics
