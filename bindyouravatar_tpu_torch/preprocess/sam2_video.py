"""SAM2 video predictor: prompt on frame 0, propagate masks through time
(the port of `bindyouravatar_tpu/preprocess/sam2_video.py`).

`SAM2Model` holds the sub-modules of `models/sam2.py` under sam2.1's names
and exposes the stages the loop calls.  `SAM2VideoPredictor` keeps the
contract of `sam2.build_sam2_video_predictor` that the mask tool uses:
`init_state` on a frame stack, `add_new_points` per object, then
`propagate_in_video` yielding per-frame mask logits per object.

Tracking (sam2.1 semantics, as JAX): each frame's /16 features are
conditioned on the object's memory bank (the prompted frame's memory, up to
`num_maskmem - 1` most recent memories, each slot tagged with a learned
temporal embedding, and the last `max_obj_ptrs` object pointers split into
`mem_dim` chunks) through the RoPE memory attention; the decoder runs
promptless on the other frames and its mask is encoded into a new memory.
Frame features and the memory bank stay on the model's device; the
predictor computes in the dtype of the model's weights (float32 as JAX's).

`load_sam2_predictor` reads a sam2.1 checkpoint ("model" dict) strictly:
the port's modules carry its names, and `sam2_state_dict` reshapes the two
tensors JAX's importer reshapes and drops the sam2.1 parts this
architecture does not have (`SAM2_UNUSED`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.sam2 import (MLP, ImageEncoder, MaskDecoder, MemoryAttention, MemoryEncoder,
                           PromptEncoder, SAM2Config, conv_nhwc)

# sam2.1 checkpoint entries of parts JAX's SAM2 does not have (the mask
# prompt's downscaling and the mask-input downsample, the pointers'
# temporal projection, the no-object and no-memory position embeddings):
# JAX's importer never reads them, the reader drops them by name
SAM2_UNUSED = ("sam_prompt_encoder.mask_downscaling.", "mask_downsample.",
               "obj_ptr_tpos_proj.", "no_obj_ptr", "no_obj_embed_spatial", "no_mem_pos_enc")


class SAM2Model(nn.Module):
    """All SAM2 sub-modules in one module tree, sam2.1's names."""

    def __init__(self, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        c = self.cfg = cfg
        self.image_encoder = ImageEncoder(c)
        self.sam_prompt_encoder = PromptEncoder(c)
        self.sam_mask_decoder = MaskDecoder(c)
        self.memory_attention = MemoryAttention(c)
        self.memory_encoder = MemoryEncoder(c)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, c.d_model))
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(c.num_maskmem, 1, 1, c.mem_dim))
        self.obj_ptr_proj = MLP(c.d_model, c.d_model, c.d_model, 3)

    # ------------------------------------------------------------ stages
    def encode_image(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, 3, H, W] normalised -> the /16 features, their pos enc and
        the projected high-res skips."""
        out = self.image_encoder(images)
        f4, f8, f16 = out["backbone_fpn"]
        dec = self.sam_mask_decoder
        return {"feat": f16, "pos": out["vision_pos_enc"][-1],
                "hi0": conv_nhwc(dec.conv_s0, f4), "hi1": conv_nhwc(dec.conv_s1, f8)}

    def condition_features(self, feat, memory, memory_pos, rope_k_rows: int):
        """Memory-condition the /16 features: memory [B, M, mem_dim] with
        its pos encodings; rope_k_rows = the spatial memory rows."""
        b, h, w, d = feat.shape
        x = self.memory_attention(feat.reshape(b, h * w, d), memory + memory_pos, (h, w), (h, w),
                                  rope_k_rows)
        return x.reshape(b, h, w, d)

    def no_memory_features(self, feat: torch.Tensor) -> torch.Tensor:
        b, h, w, d = feat.shape
        return (feat.reshape(b, h * w, d) + self.no_mem_embed).reshape(b, h, w, d)

    def decode_masks(self, feat, hi0, hi1, points, labels):
        """-> (mask logits [B, n, 4h, 4w], iou [B, n], obj score [B, 1],
        obj ptr [B, D])."""
        b, h, w, _ = feat.shape
        pe = self.sam_prompt_encoder
        masks, iou, obj_score, mask_tokens = self.sam_mask_decoder(
            feat, pe.dense_pe(h, w).to(feat.dtype), pe(points, labels).to(feat.dtype),
            pe.dense_no_mask(b, h, w), (hi0, hi1))
        return masks, iou, obj_score, self.obj_ptr_proj(mask_tokens[:, 0])

    def encode_memory(self, feat, mask_logits_lowres):
        """(pre-memory /16 features, mask logits at 4x feat res) -> (memory
        feature map, pos enc)."""
        return self.memory_encoder(feat, mask_logits_lowres)


def build_sam2(cfg: Optional[SAM2Config] = None, device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None) -> SAM2Model:
    """A `SAM2Model` on `device` in eval mode, drawn from `generator`
    (`draw_sam2_`) when one is given, else left for `load_state_dict`."""
    with torch.device("meta"):
        model = SAM2Model(cfg or SAM2Config())
    model = model.to_empty(device=device).eval()
    return draw_sam2_(model, generator) if generator is not None else model


@torch.no_grad()
def draw_sam2_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Weights at a trained network's scale, in place: matrices and conv
    kernels ~ N(0, 1 / fan_in), embeddings and the Fourier matrix ~ N(0,
    1), norm gains ~ N(1, 0.1), biases, position and temporal embeddings
    ~ N(0, 0.02); the fuser's `gamma` ~ N(0, 0.1)."""
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        z = torch.randn(t.shape, generator=generator, device=t.device, dtype=torch.float32)
        if leaf == "weight" and t.ndim >= 2 and not _is_embedding(model, name):
            z = z / (t[0].numel() ** 0.5)
        elif leaf == "weight" and t.ndim == 1:
            z = 1.0 + 0.1 * z
        elif leaf in ("bias", "no_mem_embed", "maskmem_tpos_enc", "pos_embed",
                      "pos_embed_window"):
            z = 0.02 * z
        elif leaf == "gamma":
            z = 0.1 * z
        t.copy_(z.to(t.dtype))
    return model


def _is_embedding(model: nn.Module, name: str) -> bool:
    return isinstance(model.get_submodule(name.rsplit(".", 1)[0]), nn.Embedding)


# ---------------------------------------------------------------- #
# host-side predictor

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass
class _ObjState:
    cond_frame: int
    memories: List[Tuple[int, torch.Tensor, torch.Tensor]]   # (t, mem, pos)
    obj_ptrs: List[Tuple[int, torch.Tensor]]
    cond_memory: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    cond_mask: Optional[np.ndarray] = None   # the prompted low-res mask logits


class SAM2VideoPredictor:
    """Contract of `sam2.build_sam2_video_predictor` for the mask tool."""

    def __init__(self, model: SAM2Model):
        self.model = model.eval()
        self.cfg = model.cfg
        p = model.no_mem_embed
        self.device, self.dtype = p.device, p.dtype

    # ------------------------------------------------------------ state
    @torch.no_grad()
    def init_state(self, frames: np.ndarray) -> Dict[str, Any]:
        """frames: [T, H, W, 3] uint8 RGB -> inference state (each frame's
        features on the device)."""
        import cv2

        t, h0, w0 = frames.shape[:3]
        size = self.cfg.image_size
        feats = []
        for f in frames:
            img = (cv2.resize(f, (size, size)).astype(np.float32) / 255.0
                   - IMAGENET_MEAN) / IMAGENET_STD
            x = torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to(self.device, self.dtype)
            feats.append(self.model.encode_image(x))
        return {"frames_hw": (h0, w0), "num_frames": t, "feats": feats, "objs": {}}

    def reset_state(self, state) -> None:
        state["objs"].clear()

    # ------------------------------------------------------------ prompts
    @torch.no_grad()
    def add_new_points(self, state, frame_idx: int, obj_id: int, points: np.ndarray,
                       labels: np.ndarray):
        """points [N, 2] in original-frame pixels; labels [N] (1 pos / 0
        neg).  Returns (obj_ids, mask logits [n_obj, h4, w4] numpy)."""
        c, m = self.cfg, self.model
        h0, w0 = state["frames_hw"]
        scale = np.asarray([c.image_size / w0, c.image_size / h0], np.float32)
        pts = torch.from_numpy((points.astype(np.float32) * scale)[None]).to(self.device)
        lbs = torch.from_numpy(labels.astype(np.int32)[None]).to(self.device)
        f = state["feats"][frame_idx]
        masks, iou, _, obj_ptr = m.decode_masks(m.no_memory_features(f["feat"]), f["hi0"],
                                                f["hi1"], pts, lbs)
        best = int(torch.argmax(iou[0, 1:]).item()) + 1              # multimask slots
        mask = masks[0, best]
        obj = _ObjState(cond_frame=frame_idx, memories=[], obj_ptrs=[(frame_idx, obj_ptr[0])])
        obj.cond_memory = m.encode_memory(f["feat"], mask[None])
        obj.cond_mask = mask.float().cpu().numpy()
        state["objs"][obj_id] = obj
        ids = sorted(state["objs"])
        return ids, np.stack([self._obj_mask(state, frame_idx, i, obj.cond_mask) for i in ids])

    def _obj_mask(self, state, frame_idx, obj_id, fresh=None) -> np.ndarray:
        if fresh is not None and obj_id in state["objs"] and \
                state["objs"][obj_id].cond_frame == frame_idx:
            return fresh
        return np.full((self.cfg.image_size // 4,) * 2, -10.0, np.float32)

    # ------------------------------------------------------------ tracking
    def _memory_bank(self, obj: _ObjState):
        """(memory [1, M, mem_dim], pos [1, M, mem_dim], spatial rows)."""
        c = self.cfg
        tpos = self.model.maskmem_tpos_enc.reshape(c.num_maskmem, c.mem_dim)
        cm, cp = obj.cond_memory
        # sam2.1's temporal slots (sam2_base.py: index num_maskmem - t_pos
        # - 1): the conditioning frame -> tpos[last]; the most recent
        # memory -> tpos[0], older ones -> increasing index
        mems = [cm.reshape(1, -1, c.mem_dim) + tpos[c.num_maskmem - 1]]
        poss = [cp.reshape(1, -1, c.mem_dim)]
        recent = obj.memories[-(c.num_maskmem - 1):]
        for p_idx, (_, m, p) in enumerate(recent):                 # oldest -> newest
            mems.append(m.reshape(1, -1, c.mem_dim) + tpos[len(recent) - p_idx - 1])
            poss.append(p.reshape(1, -1, c.mem_dim))
        rope_rows = sum(m.shape[1] for m in mems)
        # object pointers, split into mem_dim chunks, zero pos enc
        ptrs = obj.obj_ptrs[-c.max_obj_ptrs:]
        if ptrs:
            pt = torch.stack([p for _, p in ptrs]).reshape(1, -1, c.mem_dim)
            mems.append(pt)
            poss.append(torch.zeros_like(pt))
        return torch.cat(mems, 1), torch.cat(poss, 1), rope_rows

    @torch.no_grad()
    def propagate_in_video(self, state, start_frame_idx: int = 0
                           ) -> Iterator[Tuple[int, List[int], np.ndarray]]:
        """Yields (frame_idx, obj_ids, mask logits [n_obj, h4, w4] numpy)."""
        c, m = self.cfg, self.model
        ids = sorted(state["objs"])
        empty_pt = torch.zeros((1, 1, 2), dtype=torch.float32, device=self.device)
        empty_lb = torch.full((1, 1), -1, dtype=torch.int32, device=self.device)
        for t in range(start_frame_idx, state["num_frames"]):
            frame_masks = []
            for oid in ids:
                obj = state["objs"][oid]
                if t == obj.cond_frame and obj.cond_mask is not None:
                    # sam2.1 returns the consolidated PROMPTED output on a
                    # conditioning frame instead of re-decoding it
                    frame_masks.append(obj.cond_mask)
                    continue
                f = state["feats"][t]
                mem, pos, rows = self._memory_bank(obj)
                feat = m.condition_features(f["feat"], mem, pos, rows)
                masks, _, _, obj_ptr = m.decode_masks(feat, f["hi0"], f["hi1"], empty_pt,
                                                      empty_lb)
                mask = masks[0, 0]                                    # the single mask slot
                frame_masks.append(mask.float().cpu().numpy())
                if t != obj.cond_frame:
                    obj.memories.append((t, *m.encode_memory(f["feat"], mask[None])))
                    obj.memories = obj.memories[-(c.num_maskmem - 1):]
                    obj.obj_ptrs.append((t, obj_ptr[0]))
                    obj.obj_ptrs = obj.obj_ptrs[-c.max_obj_ptrs:]
            yield t, ids, np.stack(frame_masks)


# ---------------------------------------------------------------- #
# checkpoint reader (sam2.1 torch "model" state dict)

def sam2_state_dict(sd: Dict[str, Any], cfg: SAM2Config) -> Dict[str, torch.Tensor]:
    """A sam2.1 "model" state dict -> the port's `SAM2Model` state dict:
    the `SAM2_UNUSED` entries dropped, `no_mem_embed` and `maskmem_tpos_enc`
    reshaped to [1, 1, d_model] and [num_maskmem, 1, 1, mem_dim] (JAX's
    importer reshapes them too), every other tensor as it is."""
    out = {}
    for k, v in sd.items():
        if k.startswith(SAM2_UNUSED):
            continue
        v = torch.as_tensor(v)
        if k == "no_mem_embed":
            v = v.reshape(1, 1, cfg.d_model)
        elif k == "maskmem_tpos_enc":
            v = v.reshape(cfg.num_maskmem, 1, 1, cfg.mem_dim)
        out[k] = v
    return out


def load_sam2_predictor(checkpoint_path, cfg: Optional[SAM2Config] = None,
                        device: torch.device | str = "cuda") -> SAM2VideoPredictor:
    """A predictor on `device` from a sam2.1 checkpoint file (or its state
    dict), loaded with `strict=True`: a missing or unknown key raises."""
    sd = checkpoint_path
    if not isinstance(sd, dict):
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd)
    cfg = cfg or SAM2Config()
    model = build_sam2(cfg, device)
    model.load_state_dict(sam2_state_dict(sd, cfg), strict=True)
    return SAM2VideoPredictor(model)
