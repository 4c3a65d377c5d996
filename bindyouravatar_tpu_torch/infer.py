"""Inference CLI of the port (the root `infer.py` of the JAX package, its
flags and defaults, plus `--device`):

    python -m bindyouravatar_tpu_torch.infer --model_size 5b --audio_path a.pt b.pt \\
        --prompt_embeds pe.npy --output_dir out
    python -m bindyouravatar_tpu_torch.infer --model_size tiny --device cpu --audio_path a.pt b.pt \\
        --num_frames 9 --height 128 --width 192 --num_inference_steps 2
    python -m bindyouravatar_tpu_torch.infer --img_file_path a.png b.png --t5_dir t5 \\
        --prompt "two people talking" --audio_path a.pt b.pt \\
        [--retinaface_checkpoint r.pth --bisenet_checkpoint b.pth --arcface_checkpoint a.pth]
    BYA_SAM2_CKPT=sam2.1_hiera_large.pt python -m bindyouravatar_tpu_torch.infer \\
        --img_file_path a.png b.png --audio_path a.pt b.pt --two_stage_generate

Flow: the conditioning encoders (`encode_conditioning`: the face stack on
the two `--img_file_path` images gives `id_cond`, `id_vit_hidden` and the
composite canvas; T5 from `--t5_dir` gives the prompt and negative
embeddings), which are freed before the DiT is built -> the pipeline -> its
weights -> the conditioning image (the `--inpaintingframe_path` background
frame, else the canvas, else a white frame) -> the audio tracks -> the
forced routing from `--tracking_mask_dir` (`prepare`) -> `generate`
(`denoise`; `run` is both) -> the mp4 and the a/v mux (`main`).  With
`--two_stage_generate` and no `--tracking_mask_dir`, `main` runs the mask
tool (`tools/sam2_tools.py`, in this process: SAM2 from `$BYA_SAM2_CKPT`,
else its coarse masks) over stage 1's mp4 into
`{output_dir}/tracking_mask_results`, turns the masks into the forced
routing and denoises again on the same pipeline with a generator seeded
with the same `--seed` (JAX `infer.py:346-364`); a failing tool raises,
where JAX keeps the stage-1 clip.  The face stack reads facexlib's and
insightface's reference files and the T5 directory itself; each face
backend falls back without its file as JAX's does, and EVA-CLIP is drawn
from seed 0 on the device (`preprocess/face.py`).  At `--model_size tiny`
the face stack takes the tiny EVA-CLIP and the DiT's LFE is sized for it,
and T5 runs in fp32.  DiT weights are drawn from `--seed` the way
`training.sft` draws them (fp32, the DiT then the VAE; cast to `--dtype`
afterwards), so `--checkpoint_dir` serves a run of the port's trainer with
the same `--model_size` and `--seed`: its trainable tensors (the EMA copy
when the run kept one) replace the drawn ones.  `--module_dir` loads the
port's sub-module files.  The reference's own files load over the draw
(`load_params`, JAX `infer.py:131-161`'s order): `--reference_transformer`
(the base transformer's safetensors shards, bf16 or fp32), the three
`--reference_{audio,face,router}_modules` `.pt` files, and `--lora_path`
peft LoRA files fused into the base q/k weights with `--lora_alpha`:

    python -m bindyouravatar_tpu_torch.infer --reference_transformer \
        diffusion_pytorch_model-0000{1,2,3}-of-00003.safetensors \
        --reference_audio_modules audio_modules.pt --reference_face_modules face_modules.pt \
        --reference_router_modules router_modules.pt --lora_path lora.safetensors \
        --img_file_path a.png b.png --audio_path a.pt b.pt --prompt_embeds pe.npy

Under `torchrun` (one process per GPU) `--tp N` splits the DiT's blocks
Megatron-style over N ranks (`parallel.tp`) and `--sp N` runs its joint
attention as ring attention over N ranks (`ops.ring_attention`); every rank
builds the same weights and inputs from `--seed`, and rank 0 writes the
outputs.  With `--two_stage_generate` rank 0 runs the mask tool on the clip
it wrote and hands every rank its status, then the forcing logits; every
rank runs stage 2 (a failing tool raises on each):

    torchrun --nproc_per_node 4 -m bindyouravatar_tpu_torch.infer --tp 4 --audio_path a.pt b.pt
    torchrun --nproc_per_node 2 -m bindyouravatar_tpu_torch.infer --sp 2 --num_frames 97 ...
    torchrun --nproc_per_node 2 -m bindyouravatar_tpu_torch.infer --tp 2 --two_stage_generate \
        --img_file_path a.png b.png --audio_path a.pt b.pt

`--tp` with `--sp`, or more ranks than the launch has, raise.  Flags that
need what the port lacks raise `NotImplementedError` naming their
`ROADMAP.md` item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card unless 'cpu' is asked for")
    # model
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="a training.sft output dir (or its checkpoints/): the latest step")
    p.add_argument("--module_dir", type=str, default=None,
                   help="dir with {audio,face,router}_modules.pt sub-module files")
    p.add_argument("--reference_transformer", type=str, nargs="*", default=None,
                   help="reference sharded safetensors for the base DiT")
    p.add_argument("--reference_audio_modules", type=str, default=None,
                   help="reference audio_modules.pt")
    p.add_argument("--reference_face_modules", type=str, default=None,
                   help="reference face_modules.pt")
    p.add_argument("--reference_router_modules", type=str, default=None,
                   help="reference router_modules.pt")
    p.add_argument("--retinaface_checkpoint", type=str, default=None,
                   help="facexlib detection_Resnet50_Final.pth")
    p.add_argument("--bisenet_checkpoint", type=str, default=None,
                   help="facexlib parsing_bisenet.pth (background whiteout)")
    p.add_argument("--arcface_checkpoint", type=str, default=None,
                   help="insightface IR-100 torch checkpoint (glintr100)")
    p.add_argument("--num_layers", type=int, default=42)
    p.add_argument("--model_size", choices=["tiny", "5b"], default="5b")
    # inputs
    p.add_argument("--img_file_path", type=str, nargs="*", default=[],
                   help="exactly 2 face images for the two-character flow")
    p.add_argument("--inpaintingframe_path", type=str, default=None)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--audio_path", type=str, nargs="*", default=[],
                   help="1-2 audio embedding .pt files")
    p.add_argument("--wav_path", type=str, nargs="*", default=[])
    p.add_argument("--speaker_pos", choices=["left", "right"], default="left")
    p.add_argument("--mute_audio_path", type=str, default=None,
                   help="mute fixture .pt (required for single-track audio)")
    p.add_argument("--prompt_embeds", type=str, default=None,
                   help="precomputed T5 embeddings .npy [1,226,4096]")
    p.add_argument("--negative_prompt_embeds", type=str, default=None,
                   help="precomputed negative T5 embeddings .npy (pairs with --prompt_embeds)")
    p.add_argument("--lora_path", type=str, nargs="*", default=None,
                   help="peft LoRA safetensors file(s) fused into the base q/k kernels")
    p.add_argument("--lora_alpha", type=float, default=128.0,
                   help="LoRA alpha (reference r=128, alpha=128)")
    p.add_argument("--t5_dir", type=str, default=None,
                   help="local T5 checkpoint+tokenizer dir (use --prompt_embeds instead)")
    # generation
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--two_stage_generate", action="store_true")
    p.add_argument("--tracking_mask_dir", type=str, default=None,
                   help="precomputed SAM2 mask dir for stage 2 forcing")
    p.add_argument("--zero2cond_cfg_flag", action="store_true")
    p.add_argument("--use_dynamic_cfg", action="store_true")
    p.add_argument("--scheduler", choices=["dpm", "ddim"], default="dpm")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--draw_routing_logits", action="store_true")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel devices")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel devices")
    return p.parse_args(argv)


def check_supported(args) -> None:
    if args.tp > 1 and args.sp > 1:
        raise SystemExit("--tp and --sp build conflicting meshes over the same ranks; use one "
                         "(a combined tp x sp mesh is future work, ROADMAP)")


def setup_parallel(args, dev: torch.device):
    """(the tp mesh or None, the sp process group or None) of a `torchrun`
    launch; joins the process group when `--tp` or `--sp` asks for ranks."""
    from .parallel.mesh import create_mesh, init_distributed, world_size

    n = max(args.tp, args.sp)
    if n == 1:
        return None, None
    init_distributed(backend="nccl" if dev.type == "cuda" else "gloo")
    world = world_size()
    if n > world or world % n:
        raise ValueError(f"--tp {args.tp} / --sp {args.sp}: the launch has {world} rank(s) "
                         f"(run under torchrun --nproc_per_node {n})")
    if args.tp > 1:
        return create_mesh(dp=None, fsdp=1, tp=args.tp, device_type=dev.type), None
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(dev.type, (world // n, n), mesh_dim_names=("dp", "sp"))
    return None, mesh.get_group("sp")


def lead() -> bool:
    """Whether this process writes the outputs (rank 0, or the only one)."""
    from .parallel.mesh import rank

    return rank() == 0


def restore_trainable(checkpoint_dir: str):
    """The trainable tensors of a `training.sft` run's latest checkpoint (its
    EMA copy when the run kept one), by the DiT's parameter names."""
    from .training.checkpoint import restore_checkpoint

    sub = os.path.join(checkpoint_dir, "checkpoints")
    state = restore_checkpoint(sub if os.path.isdir(sub) else checkpoint_dir)["state"]
    return state["ema"] if state["ema"] is not None else state["params"]


def tiny_eva(device: torch.device):
    """The tiny tier's EVA-CLIP: the JAX `EVACLIPVision.tiny` shapes drawn
    from seed 0 on `device`."""
    from .models.eva_clip import EVAVisionTower

    return EVAVisionTower.tiny(device, torch.Generator(device).manual_seed(0))


def _free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def encode_conditioning(args, device: torch.device) -> dict:
    """The encoders' outputs, computed before the DiT is built and freed
    after: from `--img_file_path` (exactly 2 images) `id_cond` [1, 2,
    512 + pooled], `id_vit_hidden` [1, 2, 5, S, width] and the `canvas`
    [H, W, 3] uint8 through the face stack (`build_default_processor` with
    the three checkpoint flags), and from `--t5_dir` the prompt and
    negative embeddings `pe`, `ne` [1, L, d_model] (float32 numpy)."""
    from .config import DiTConfig, tiny_dit_config

    out = {}
    if args.img_file_path:
        if len(args.img_file_path) != 2:
            raise ValueError(f"--img_file_path: expected exactly 2 face images, got "
                             f"{len(args.img_file_path)}")
        import cv2

        from .preprocess.face import build_default_processor

        proc = build_default_processor(
            eva=tiny_eva(device) if args.model_size == "tiny" else None,
            retinaface_checkpoint=args.retinaface_checkpoint,
            bisenet_checkpoint=args.bisenet_checkpoint,
            arcface_checkpoint=args.arcface_checkpoint, device=device)
        imgs = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in args.img_file_path]
        out.update(proc.process_split(imgs, (args.height, args.width)))
        del proc
        _free(device)
    if args.t5_dir and not args.prompt_embeds:
        from .models.t5 import encode_prompts, load_t5_encoder

        tiny = args.model_size == "tiny"
        max_len = (tiny_dit_config() if tiny else DiTConfig()).max_text_seq_length
        t5 = load_t5_encoder(args.t5_dir, device, **({"dtype": torch.float32} if tiny else {}))
        out["pe"], out["ne"] = (
            encode_prompts(t5, [p], args.t5_dir, max_length=max_len).float().cpu().numpy()
            for p in (args.prompt, args.negative_prompt))
        del t5
        _free(device)
    return out


def build_models(args, device: torch.device, lora_rank: int = 0,
                 face_dims: Optional[dict] = None):
    """The pipeline on the inference path, weights drawn from `--seed` as
    `training.sft` draws them (see the module docstring).  At tiny,
    `face_dims` (the face stack's `id_embed_dim` and `vit_dim`) size the
    LFE."""
    from .config import DiTConfig, PipelineConfig, VAEConfig
    from .models.dit import DiT
    from .models.vae import CausalVAE
    from .pipeline.pipeline import BindYourAvatarPipeline

    gen = torch.Generator(device).manual_seed(args.seed)
    lora = dict(lora_rank=lora_rank, lora_alpha=args.lora_alpha)
    if args.model_size == "tiny":
        # a bg inpainting frame takes a third latent block (reference
        # `infer.py:48`: 16 noise + 16 image + 16 bg); the tiny VAE has 4
        in_ch = 12 if args.inpaintingframe_path else 8
        dit = DiT.tiny(device=device, generator=gen, lfe=face_dims, in_channels=in_ch,
                       out_channels=4, **lora)
        vae = CausalVAE.tiny(device=device, generator=gen)
    else:
        dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
        dit = DiT.create(DiTConfig(num_layers=args.num_layers, dtype=dt, **lora),
                         device=device, generator=gen)
        vae = CausalVAE.create(VAEConfig(dtype=dt), device=device, generator=gen)
    pipe_cfg = PipelineConfig(
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
        use_dynamic_cfg=args.use_dynamic_cfg, scheduler_type=args.scheduler,
        zero2cond_cfg=args.zero2cond_cfg_flag)
    return BindYourAvatarPipeline.create(dit.eval(), vae.eval(), pipe_cfg)


@torch.no_grad()
def load_params(pipe, args, trainable=None) -> dict:
    """Load into the pipeline's DiT in place, in JAX `load_params`' order:
    `--reference_transformer`'s base weights, the checkpoint's trainable
    tensors, `--module_dir`'s sub-module files, the reference sub-module
    files, then `--lora_path` fused with `--lora_alpha`; then cast the 5b
    DiT to `--dtype` (JAX's `param_dtype`).  Returns the seconds each group
    took to read and load."""
    from .training.checkpoint import (fuse_lora_files, import_reference_dit, load_named,
                                      load_submodules)
    from .training.import_submodules import import_all_submodules

    dit, seconds = pipe.dit, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        if dit.patch_embed.proj.weight.is_cuda:
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0

    if args.reference_transformer:
        timed("transformer", lambda: import_reference_dit(args.reference_transformer, dit))
    if trainable is not None:
        load_named(dit, trainable.items(), source=f"{args.checkpoint_dir} (same --model_size "
                                                  f"and --inpaintingframe_path?)")
    if args.module_dir:
        load_submodules(dit, args.module_dir)
    for group in ("audio", "face", "router"):
        path = getattr(args, f"reference_{group}_modules")
        if path:
            timed(group, lambda: import_all_submodules(dit, **{group: path}))
    if args.lora_path:
        timed("lora", lambda: fuse_lora_files(args.lora_path, dit, lora_alpha=args.lora_alpha))
        print(f"[lora] fused {len(args.lora_path)} LoRA file(s) (alpha={args.lora_alpha}) into "
              f"the base q/k weights")
    if args.model_size == "5b" and args.dtype == "bf16":
        dit.to(torch.bfloat16)
        dit.cfg = dataclasses.replace(dit.cfg, param_dtype=torch.bfloat16)
    return seconds


def save_routing_debug(routing, grid, output_dir: str, fps: int) -> None:
    """Per-layer routing masks of the final denoise step and the mean over
    steps and layers as mp4s (reference `draw_routing_logit`).  routing:
    [steps, num_ca, B, S, I] or None (the face path did not run)."""
    from .utils.media import save_routing_video

    if routing is None:
        print("[warn] --draw_routing_logits: the face/router path is off (no id "
              "conditioning): no routing logits to draw", file=sys.stderr)
        return
    r = np.asarray(routing, np.float32)
    dbg = os.path.join(output_dir, "routing_logits")
    os.makedirs(dbg, exist_ok=True)
    for layer in range(r.shape[1]):
        save_routing_video(r[-1, layer, 0], grid,
                           os.path.join(dbg, f"final_step_layer{layer:02d}.mp4"), fps=fps)
    save_routing_video(r[:, :, 0].mean(axis=(0, 1)), grid,
                       os.path.join(dbg, "mean_over_steps_layers.mp4"), fps=fps)
    print(f"[routing] wrote {r.shape[1] + 1} mask videos to {dbg}")


@dataclasses.dataclass
class Prepared:
    """What `prepare` built: the pipeline with its weights and `generate`'s
    inputs on the device (`cond` holds the face, audio and forced-routing
    keyword arguments), and the clock's start."""
    args: argparse.Namespace
    pipe: object
    pe: torch.Tensor
    ne: torch.Tensor
    image: torch.Tensor
    image_bg: Optional[torch.Tensor]
    cond: dict
    t0: float
    load_seconds: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class InferRun:
    """What `run` made: the clip [1, T, 3, H, W] in [-1, 1] (numpy), the
    routing [steps, num_ca, 1, S, I] when `--draw_routing_logits` asked for
    it (None when the face path did not run), the latent grid and the
    meta line's fields; `prep` keeps the pipeline for a second denoise."""
    video: np.ndarray
    routing: Optional[np.ndarray]
    grid: tuple
    meta: dict
    prep: Optional[Prepared] = None


def prepare(args) -> Prepared:
    """Everything before `generate`: the encoders, the pipeline and its
    weights, the inputs."""
    check_supported(args)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    tp_mesh, sp_group = setup_parallel(args, dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    from .preprocess.audio import load_precomputed
    from .training.data import AUDIO_WINDOW_SLACK, af_matrix_from_speaker
    from .utils.masks import masks_to_routing_logits

    t0 = time.time()
    enc = encode_conditioning(args, dev)
    face_dims = None
    if "id_cond" in enc and args.model_size == "tiny":
        face_dims = dict(id_embed_dim=enc["id_cond"].shape[-1],
                         vit_dim=enc["id_vit_hidden"].shape[-1])
    trainable = restore_trainable(args.checkpoint_dir) if args.checkpoint_dir else None
    lora_rank = next((t.shape[1] for k, t in (trainable or {}).items()
                      if k.endswith("to_q_lora_A")), 0)
    pipe = build_models(args, dev, lora_rank, face_dims)
    load_seconds = load_params(pipe, args, trainable)
    if tp_mesh is not None:
        from .parallel.tp import shard_params_tp

        shard_params_tp(pipe.dit, tp_mesh)
        print(f"[tp] DiT blocks split over {args.tp} ranks")
    if sp_group is not None:
        pipe.sp_group = sp_group
        print(f"[sp] ring attention over {args.sp} ranks")
    c = pipe.dit.cfg

    # the conditioning image: the bg frame if given, else the face stack's
    # composite canvas, else a white frame
    image_bg = None
    if args.inpaintingframe_path:
        import cv2

        bg = cv2.cvtColor(cv2.imread(args.inpaintingframe_path), cv2.COLOR_BGR2RGB)
        image_np = cv2.resize(bg, (args.width, args.height))
    elif "canvas" in enc:
        image_np = enc["canvas"]
    else:
        image_np = np.full((args.height, args.width, 3), 255, np.uint8)
    to_model = lambda a: torch.from_numpy(
        (a.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1))[None, None].to(dev)
    image = to_model(image_np)
    if args.inpaintingframe_path:
        image_bg = image

    cond = {}
    if "id_cond" in enc:
        cond["id_cond"] = torch.from_numpy(enc["id_cond"]).to(dev)
        cond["id_vit_hidden"] = torch.from_numpy(enc["id_vit_hidden"]).to(dev)
    if args.audio_path:
        need = args.num_frames + AUDIO_WINDOW_SLACK

        def padded(path):
            emb = load_precomputed(path)[:need]
            out = np.zeros((need,) + emb.shape[1:], np.float32)
            out[: emb.shape[0]] = emb
            return out

        tracks = [padded(p) for p in args.audio_path]
        cond["audio_embeds"] = torch.from_numpy(np.stack(tracks)[None]).to(dev)
        if len(tracks) == 1:
            if not args.mute_audio_path:
                raise SystemExit("single audio track requires --mute_audio_path")
            cond["mute_embeds"] = torch.from_numpy(padded(args.mute_audio_path)).to(dev)
        cond["af_matrix"] = torch.from_numpy(
            af_matrix_from_speaker(args.speaker_pos == "left", c.num_ids)[None]).to(dev)

    if args.prompt_embeds:
        pe = np.load(args.prompt_embeds).astype(np.float32)
        if args.negative_prompt_embeds:
            ne = np.load(args.negative_prompt_embeds).astype(np.float32)
            if ne.shape != pe.shape:
                raise ValueError(f"negative embeds {ne.shape} != prompt embeds {pe.shape}")
        else:
            print("[warn] no --negative_prompt_embeds: using ZERO negative embeddings (the "
                  "reference encodes a real negative prompt: CFG quality differs)",
                  file=sys.stderr)
            ne = np.zeros_like(pe)
    elif "pe" in enc:
        pe, ne = enc["pe"], enc["ne"]
    else:
        print("[warn] no --prompt_embeds / --t5_dir: using ZERO text embeddings: the output is "
              "UNCONDITIONED on the prompt (smoke / perf runs only)", file=sys.stderr)
        pe = np.zeros((1, c.max_text_seq_length, c.text_embed_dim), np.float32)
        ne = np.zeros_like(pe)

    if args.tracking_mask_dir:
        t_lat, gh, gw = c.latent_grid
        cond["routing_forcing"] = torch.from_numpy(
            masks_to_routing_logits(args.tracking_mask_dir, t_lat, gh, gw)).to(dev)

    return Prepared(args=args, pipe=pipe, pe=torch.from_numpy(pe).to(dev),
                    ne=torch.from_numpy(ne).to(dev), image=image, image_bg=image_bg, cond=cond,
                    t0=t0, load_seconds=load_seconds)


def denoise(prep: Prepared, routing_forcing: Optional[torch.Tensor] = None,
            return_routing: bool = False) -> InferRun:
    """`generate` on the prepared pipeline and inputs with a generator
    seeded with `--seed`; `routing_forcing` replaces `--tracking_mask_dir`'s."""
    args, pipe = prep.args, prep.pipe
    cond = dict(prep.cond)
    if routing_forcing is not None:
        cond["routing_forcing"] = routing_forcing
    gen = torch.Generator(prep.pe.device).manual_seed(args.seed)
    out = pipe.generate(prep.pe, prep.ne, prep.image, gen, image_bg=prep.image_bg,
                        return_routing=return_routing, **cond)
    video, routing = out if return_routing else (out, None)
    meta = {"seconds": round(time.time() - prep.t0, 1), "frames": args.num_frames,
            "steps": args.num_inference_steps}
    return InferRun(video=video.float().cpu().numpy(),
                    routing=None if routing is None else routing.float().cpu().numpy(),
                    grid=pipe.dit.cfg.latent_grid, meta=meta, prep=prep)


def run(args) -> InferRun:
    """Everything up to and including `generate` (`prepare`, `denoise`)."""
    return denoise(prepare(args), return_routing=args.draw_routing_logits)


def _from_lead(obj):
    """Rank 0's `obj` on every rank of the launch (itself on one rank)."""
    from .parallel.mesh import world_size

    if world_size() == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def second_stage(res: InferRun, video_path: str) -> InferRun:
    """Stage 2 of `--two_stage_generate` (JAX `infer.py:346-364`): the mask
    tool over stage 1's clip into `{output_dir}/tracking_mask_results`, the
    masks as the forced routing, and the denoise again on the same pipeline
    and seed.  A failing tool raises (JAX keeps the stage-1 clip).  Under
    `--tp` / `--sp` rank 0, which wrote the clip, runs the tool and reads
    the masks; its status goes to every rank first (a failure raises on
    each, with the tool's error), then the forcing logits, and every rank
    runs the sharded denoise."""
    from .tools.sam2_tools import make_masks
    from .utils.masks import masks_to_routing_logits

    args = res.prep.args
    mask_dir = os.path.join(args.output_dir, "tracking_mask_results")
    t0 = time.time()
    error = cause = logits = None
    if lead():
        try:
            make_masks(video_path, mask_dir, device=args.device)
        except Exception as e:
            error, cause = (f"--two_stage_generate: the mask tool failed on {video_path}: "
                            f"{type(e).__name__}: {e}"), e
        else:
            if not os.path.isdir(os.path.join(mask_dir, "1")):
                error = f"--two_stage_generate: the mask tool wrote no masks to {mask_dir}"
    error = _from_lead(error)
    if error is not None:
        raise RuntimeError(error) from cause
    if lead():
        logits = masks_to_routing_logits(mask_dir, *res.grid)
    logits = _from_lead(logits)
    tool_s = time.time() - t0
    dev = res.prep.pe.device
    _free(dev)
    forcing = torch.from_numpy(logits).to(dev)
    t1 = time.time()
    out = denoise(res.prep, routing_forcing=forcing)
    out.meta.update(mask_dir=mask_dir, mask_tool_seconds=round(tool_s, 1),
                    stage2_seconds=round(time.time() - t1, 1))
    return out


def main(argv=None) -> str:
    """`run`, then the mp4, the `--draw_routing_logits` videos, stage 2 of
    `--two_stage_generate` (which overwrites the mp4), the `--wav_path` mux
    and the meta line; returns the output path.  Under `--tp` / `--sp` every
    rank runs both stages and only rank 0 writes."""
    args = get_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    from .utils.media import export_to_video, merge_audio_files, merge_audio_video

    t0 = time.time()
    res = run(args)
    out_path = os.path.join(args.output_dir, "output.mp4")
    if lead():
        out_path = export_to_video(res.video[0], out_path, fps=args.fps)
        if args.draw_routing_logits:
            save_routing_debug(res.routing, res.grid, args.output_dir, args.fps)
    if args.two_stage_generate and not args.tracking_mask_dir:
        stage1_s = round(time.time() - t0, 1)
        res = second_stage(res, out_path)
        res.meta["stage1_seconds"] = stage1_s
        if lead():
            export_to_video(res.video[0], out_path, fps=args.fps)
    if not lead():
        return out_path
    if args.wav_path:
        wav = args.wav_path[0]
        if len(args.wav_path) > 1:
            wav = merge_audio_files(args.wav_path, os.path.join(args.output_dir, "mixed.wav"))
        out_path = merge_audio_video(out_path, wav, os.path.join(args.output_dir,
                                                                 "output_av.mp4"))
    print(json.dumps({"output": out_path, **res.meta, "seconds": round(time.time() - t0, 1)}))
    return out_path


if __name__ == "__main__":
    main()
