"""Stage-3 fine-tune launcher of the port (the JAX package's
`scripts/sft.py`, its flags and defaults, plus `--device`):

    python -m bindyouravatar_tpu_torch.training.sft --model_size 5b --output_dir runs/sft
    python -m bindyouravatar_tpu_torch.training.sft --model_size tiny --device cpu

The data (synthetic at the configuration's frames and size, or with
`--index_file` the reference's on-disk layout through `AvatarVideoDataset`,
at the configuration's frames and size), the VAE, the DiT with LoRA, the
trainer (`--optimizer adamw|adafactor|prodigy`, `--use_8bit_adam` with
AdamW only, the prodigy flags) and the driver with auto-resume; with
`--num_validation_videos N`, N videos of `--validation_steps` steps from the
live DiT at every checkpoint (`validation-{step}/video_{i}.mp4`).  Weights
are drawn from `--seed`; `--reference_transformer` (the reference's
safetensors shards) then replaces the base transformer's, its patch embed
grown with zero channels to the DiT's (48 at 5b), while the LoRA slots and
the conditioning modules keep their draw (JAX `scripts/sft.py:138-142`),
and `--module_dir` the sub-modules'.  `--model_size 5b` is the 42-layer DiT
(dim 3072, 48 x 64 heads, 226 + 17,550 tokens, face and audio, LoRA r128)
over 49 x 480 x 720 clips.  Its stand-in text and face embeddings are
drawn once from the seed (the launcher runs no T5 or EVA-CLIP) and given
to every batch, so a resumed run sees the same ones; the EVA-CLIP hidden
states have 577 tokens at 5b (the serving path's length; the JAX
launcher's stand-in has 9).  `--num_layers` cuts the 5b depth (widths stay
full).  `--use_8bit_adam` with another optimizer raises `ValueError` (JAX
ignores it there).

Under `torchrun` (one process per GPU) the run is sharded: `--fsdp F`
(default: the world size) ranks shard the DiT (`parallel.sharding`) and the
rest form the dp axis (JAX `scripts/sft.py:134-136`); `--batch_size` is the
global batch, each rank takes its slice.  An fsdp size that the world does
not divide, or that exceeds it, raises.  Every optimizer runs sharded: the
statistics that span a split tensor (adafactor's factored means and block
RMS, prodigy's sums, 8-bit AdamW's block absmax) are summed over the fsdp
group (`training/shards.py`), and a checkpoint holds the whole state, so it
restores at any rank count:

    torchrun --nproc_per_node 8 -m bindyouravatar_tpu_torch.training.sft \
        --model_size 5b --fsdp 8 --optimizer prodigy --output_dir runs/sft
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--index_file", type=str, default=None,
                   help="training index txt (reference layout); omit for synthetic")
    p.add_argument("--output_dir", type=str, default="runs/sft")
    p.add_argument("--model_size", choices=["tiny", "5b"], default="tiny")
    p.add_argument("--device", type=str, default="cuda",
                   help="the card unless 'cpu' is asked for")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=10000)
    p.add_argument("--learning_rate", type=float, default=1e-5,
                   help="on --resume this overrides the stored LR while keeping the "
                        "optimizer state (reference train.py:909-921)")
    p.add_argument("--text_drop_ratio", type=float, default=0.0,
                   help="prob of training with an empty caption (on-disk data only)")
    p.add_argument("--optimizer", choices=["adamw", "adafactor", "prodigy"], default="adamw")
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="block-wise 8-bit AdamW state (AdamW only; training/adam8bit.py)")
    p.add_argument("--prodigy_beta3", type=float, default=None)
    p.add_argument("--prodigy_decouple", type=bool, default=True)
    p.add_argument("--prodigy_use_bias_correction", type=bool, default=False)
    p.add_argument("--prodigy_safeguard_warmup", type=bool, default=False)
    p.add_argument("--lora_rank", type=int, default=128)
    p.add_argument("--lora_alpha", type=float, default=128.0)
    p.add_argument("--checkpointing_steps", type=int, default=100)
    p.add_argument("--checkpoints_total_limit", type=int, default=3)
    p.add_argument("--router_loss_weight", type=float, default=1.0)
    p.add_argument("--consistency_loss_weight", type=float, default=8.0)
    p.add_argument("--temporal_diff_loss_weight", type=float, default=0.002)
    p.add_argument("--spatial_diff_loss_weight", type=float, default=0.0009)
    p.add_argument("--spatial_dist_loss_weight", type=float, default=10.0)
    p.add_argument("--id_dist_loss_weight", type=float, default=10.0)
    p.add_argument("--mask_prob", type=float, default=0.2)
    p.add_argument("--index_mask_drop_prob", type=float, default=0.2)
    p.add_argument("--noised_image_dropout", type=float, default=0.05)
    p.add_argument("--no_image_noise", action="store_true",
                   help="no mask-modulated conditioning-image noise (reference "
                        "process_image, on by default)")
    p.add_argument("--no_stochastic_vae", action="store_true",
                   help="encode the posterior mode instead of a sample")
    p.add_argument("--ema_decay", type=float, default=None)
    p.add_argument("--remat_policy", choices=["none", "save_attn", "nested"], default="none",
                   help="5b checkpointing: per layer group (none), the joint attention's "
                        "outputs kept (save_attn), or each block too (nested)")
    p.add_argument("--fsdp", type=int, default=None,
                   help="fsdp axis size (default: the world size under torchrun); every "
                        "--optimizer (and --use_8bit_adam) steps on the ranks' parts")
    p.add_argument("--resume", type=str, default="latest", help="'latest' or 'none'")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--module_dir", type=str, default=None,
                   help="pretrained audio/face/router sub-modules (modules-{step})")
    p.add_argument("--reference_transformer", type=str, nargs="*", default=None,
                   help="reference safetensors shards of the base transformer")
    p.add_argument("--num_validation_videos", type=int, default=0)
    p.add_argument("--validation_steps", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=None,
                   help="5b depth cut (widths stay full); default the configuration's 42")
    return p.parse_args(argv)


def _check_supported(args) -> None:
    if args.use_8bit_adam and args.optimizer != "adamw":
        raise ValueError(f"--use_8bit_adam is AdamW's option, not --optimizer "
                         f"{args.optimizer}'s (the JAX launcher ignores it there)")


def make_mesh(fsdp: Optional[int], dev: torch.device):
    """The (dp, fsdp) mesh of a `torchrun` launch (None on one rank):
    fsdp defaults to the world size, dp takes the rest."""
    from ..parallel.mesh import create_mesh, init_distributed, world_size

    init_distributed(backend="nccl" if dev.type == "cuda" else "gloo")
    n = world_size()
    fsdp = n if fsdp is None else fsdp
    if fsdp > n or n % fsdp:
        raise ValueError(f"--fsdp {fsdp} does not divide the {n} rank(s) of the launch")
    return create_mesh(dp=n // fsdp, fsdp=fsdp, device_type=dev.type) if n > 1 else None


@dataclasses.dataclass
class SftRun:
    driver: object
    state: object


def main(argv=None, resume_fn: Optional[Callable] = None) -> SftRun:
    """Build and run; `resume_fn(driver, state)` is called after a restore
    (see `TrainDriver.run`)."""
    args = get_args(argv)
    _check_supported(args)
    from ..config import DiTConfig, SchedulerConfig, TrainConfig, VAEConfig
    from ..models.dit import DiT
    from ..models.vae import CausalVAE
    from ..ops.scheduler import Schedule
    from .checkpoint import import_reference_dit, load_submodules
    from .data import AvatarVideoDataset, SyntheticAvatarDataset
    from .train_loop import TrainDriver
    from .trainer import Trainer

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    mesh = make_mesh(args.fsdp, dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = TrainConfig(
        learning_rate=args.learning_rate, max_train_steps=args.max_train_steps,
        optimizer=args.optimizer, use_8bit_adam=args.use_8bit_adam,
        prodigy_beta3=args.prodigy_beta3, prodigy_decouple=args.prodigy_decouple,
        prodigy_use_bias_correction=args.prodigy_use_bias_correction,
        prodigy_safeguard_warmup=args.prodigy_safeguard_warmup,
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        router_loss_weight=args.router_loss_weight,
        consistency_loss_weight=args.consistency_loss_weight,
        temporal_diff_loss_weight=args.temporal_diff_loss_weight,
        spatial_diff_loss_weight=args.spatial_diff_loss_weight,
        spatial_dist_loss_weight=args.spatial_dist_loss_weight,
        id_dist_loss_weight=args.id_dist_loss_weight,
        mask_prob=args.mask_prob, index_mask_drop_prob=args.index_mask_drop_prob,
        noised_image_dropout=args.noised_image_dropout, image_noise=not args.no_image_noise,
        stochastic_vae=not args.no_stochastic_vae, ema_decay=args.ema_decay, seed=args.seed)

    gen = torch.Generator(dev).manual_seed(args.seed)
    if args.model_size == "tiny":
        if args.num_layers is not None:
            raise ValueError("--num_layers cuts the 5b depth only")
        dit = DiT.tiny(device=dev, generator=gen, lora_rank=min(args.lora_rank, 8),
                       in_channels=8, out_channels=4)
        vae = CausalVAE.tiny(device=dev, generator=gen)
        vit_tokens = 9
    else:
        depth = {} if args.num_layers is None else {"num_layers": args.num_layers}
        dit = DiT.create(DiTConfig(lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
                                   remat=True, **depth,
                                   remat_policy=None if args.remat_policy == "none"
                                   else args.remat_policy), device=dev, generator=gen)
        vae = CausalVAE.create(VAEConfig(), device=dev, generator=gen)
        vit_tokens = 577
    if args.reference_transformer:
        import_reference_dit(args.reference_transformer, dit)
    if args.module_dir:
        load_submodules(dit, args.module_dir)

    c, lfe = dit.cfg, dit.lfe_cfg
    if args.index_file:
        # the clip size of the configuration (JAX's launcher leaves the
        # dataset's 480 x 720, the 5b configuration's), errors logged in the run
        dataset = AvatarVideoDataset(args.index_file, num_frames=c.sample_frames,
                                     height=c.sample_height * 8, width=c.sample_width * 8,
                                     text_drop_ratio=args.text_drop_ratio,
                                     error_log=os.path.join(args.output_dir, "error_log.txt"))
    else:
        dataset = SyntheticAvatarDataset(
            length=64, num_frames=c.sample_frames, height=c.sample_height * 8,
            width=c.sample_width * 8, audio_blocks=dit.audio_cfg.blocks,
            audio_dim=dit.audio_cfg.audio_dim)
    rngc = np.random.default_rng(args.seed)
    stand_in = dict(
        text_embeds=rngc.normal(0, 1, (1, c.max_text_seq_length, c.text_embed_dim)),
        id_cond=rngc.normal(0, 1, (1, c.num_ids, lfe.id_embed_dim)),
        id_vit_hidden=rngc.normal(0, 1, (1, c.num_ids, lfe.num_scales, vit_tokens, lfe.vit_dim)))
    stand_in = {k: v.astype(np.float32) for k, v in stand_in.items()}

    def extras(sample):
        b = sample["video"].shape[0]
        return {k: np.repeat(v, b, axis=0) for k, v in stand_in.items()}

    trainer = Trainer(dit, Schedule.create(SchedulerConfig()), cfg, mesh=mesh)
    driver = TrainDriver(trainer=trainer, vae=vae, cfg=cfg, output_dir=args.output_dir,
                         device=dev)
    validation_fn = None
    if args.num_validation_videos > 0:
        # every-checkpoint videos from the live DiT (JAX `scripts/sft.py:178-194`)
        from ..config import PipelineConfig
        from ..pipeline.pipeline import BindYourAvatarPipeline
        from .validation import make_validation_fn

        pipe = BindYourAvatarPipeline.create(dit, vae, PipelineConfig(
            height=c.sample_height * 8, width=c.sample_width * 8, num_frames=c.sample_frames))
        dit.set_fuse_qk_norm(False)         # `create` set the inference path: train first
        val_pe = rngc.normal(0, 1, (1, c.max_text_seq_length, c.text_embed_dim))
        validation_fn = make_validation_fn(
            pipe, args.output_dir, val_pe.astype(np.float32),
            num_inference_steps=args.validation_steps, num_videos=args.num_validation_videos,
            seed=args.seed)
    state = driver.run(dataset, batch_size=args.batch_size, make_batch_extras=extras,
                       resume=args.resume, resume_fn=resume_fn, validation_fn=validation_fn)
    return SftRun(driver=driver, state=state)


if __name__ == "__main__":
    main()
    sys.exit(0)
