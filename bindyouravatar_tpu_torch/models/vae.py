"""Causal 3D VAE in torch (port of `bindyouravatar_tpu/models/vae.py`).

CogVideoX `AutoencoderKLCogVideoX` semantics: causal temporal padding by
first-frame replication, fp32 group norms, avg-pool temporal downsample
with the odd first frame passed through, nearest 2t-1 temporal / 2x spatial
upsampling.  Internally NCDHW (torch's conv layout); the public tensors keep
the JAX layout: video [B, T, 3, H, W], latents [B, T', C, H/8, W/8].
Module names follow the flax tree (`down_0_res_0`, `norm_layer.gn`, ...).

Without autograd (the decode always; the encode under `no_grad`), group
norms, causal convs and the spatial upsamples over more than
`SLICE_ELEMENTS` elements compute the same function a slice at a time
(group norms' statistics by groups, convs and upsamples by output frames,
causal convs with their causal context) into one output.  A resnet block
over such a tensor makes each conv's input a slice at a time from its
source (norm, modulation, SiLU: `GroupNorm.stats` / `apply_frames`), so
no normalised copy of a whole clip exists, writes its second conv over
its first conv's output (a slice's causal context is kept from the slice
before, so no frame is read after it is overwritten), and adds its
shortcut a slice at a time: a block holds two whole-clip activations, its
input and its output.
A whole 49 x 480 x 720 clip then encodes in about a third of the memory
of the one-pass ops (each 128-channel activation there is 4 GiB in bf16),
and a 193-frame clip decodes whole on one 80 GB card beside the 5B DiT.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import VAEConfig
from .layers import init_random_

# without autograd, ops over more elements than this run a slice at a time
SLICE_ELEMENTS = 1 << 27


class _Conv(nn.Conv3d):
    """nn.Conv3d computing in `compute_dtype` (flax `nn.Conv(dtype=...)`)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0,
                 compute_dtype=torch.bfloat16, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        return F.conv3d(x.to(cd), self.weight.to(cd), self.bias.to(cd), self.stride,
                        self.padding)


class CausalConv3d(nn.Module):
    """3D conv, temporally causal: front-pad (kt-1) replicated first frames."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int] = (3, 3, 3), **kw):
        super().__init__()
        self.kernel = kernel
        self.conv = _Conv(cin, cout, kernel, **kw)

    def forward(self, x):
        kt, kh, kw = self.kernel
        if torch.is_grad_enabled() or x.numel() <= SLICE_ELEMENTS:
            if kt > 1:
                x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
            return self.conv(F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2)))
        return self.stream(lambda lo, hi: x[:, :, lo:hi], x.shape[2], x[:, :, :1].numel())

    def stream(self, frames, t: int, frame_numel: int, out=None):
        """This conv, without autograd, over a `t`-frame input whose frames
        [a, b) `frames(a, b)` makes, a slice of output frames at a time
        (`frame_numel` elements an input frame set the slice), each input
        frame made once: output frames [a, b) read input frames [a - kt +
        1, b), the first kt - 1 of them kept from the slice before (frame 0
        repeated before the start); the spatial zero padding is the conv's.
        Into `out` (made when None), which may be the input's own storage:
        a slice is written after its frames are made, and no later slice
        reads them again."""
        kt, kh, kw = self.kernel
        c = self.conv
        w, bias = c.weight.to(c.compute_dtype), c.bias.to(c.compute_dtype)
        step = max(1, SLICE_ELEMENTS // frame_numel)
        context = None
        for a in range(0, t, step):
            b = min(t, a + step)
            xs = frames(a, b)
            if kt > 1:
                if context is None:
                    context = xs[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
                xs = torch.cat([context, xs], dim=2)
                context = xs[:, :, -(kt - 1):]
            ys = F.conv3d(xs.to(c.compute_dtype), w, bias, 1, (0, kh // 2, kw // 2))
            if out is None:
                out = ys.new_empty(ys.shape[:2] + (t,) + ys.shape[3:])
            out[:, :, a:b] = ys
        return out


class GroupNorm(nn.Module):
    """GroupNorm in fp32, output in the input dtype."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.gn = nn.GroupNorm(groups, channels, eps=eps, dtype=dtype)

    def forward(self, x):
        g = self.gn
        if torch.is_grad_enabled() or x.numel() <= SLICE_ELEMENTS:
            return F.group_norm(x.float(), g.num_groups, g.weight.float(), g.bias.float(),
                                g.eps).to(x.dtype)
        out = torch.empty_like(x)
        stats, t = self.stats(x), x.shape[2]
        step = max(1, SLICE_ELEMENTS // x[:, :, :1].numel())
        for a in range(0, t, step):
            out[:, :, a:a + step] = self.apply_frames(x, a, min(t, a + step), stats)
        return out

    def stats(self, x):
        """fp32 (scale, shift) [N, C] that normalise x [N, C, ...] channel
        by channel.  Each group's statistics are its own: a few groups at a
        time, by a reduction over the whole device (F.group_norm gives each
        (sample, group) row one block: ten times slower here)."""
        g = self.gn
        n, cpg = x.shape[0], x.shape[1] // g.num_groups
        per = max(1, SLICE_ELEMENTS // (x.numel() // g.num_groups))     # groups a slice
        scales, shifts = [], []
        for g0 in range(0, g.num_groups, per):
            k = min(per, g.num_groups - g0)
            c0, c1 = g0 * cpg, (g0 + k) * cpg
            xf = x[:, c0:c1].to(torch.float32, copy=True)
            var, mean = torch.var_mean(xf.view(n, k, -1), dim=2, unbiased=False)
            scale = torch.rsqrt(var + g.eps)[..., None] * g.weight[c0:c1].float().view(1, k, cpg)
            shift = g.bias[c0:c1].float().view(1, k, cpg) - mean[..., None] * scale
            scales.append(scale.reshape(n, -1))
            shifts.append(shift.reshape(n, -1))
        return torch.cat(scales, 1), torch.cat(shifts, 1)

    def apply_frames(self, x, lo: int, hi: int, stats, zq=None):
        """The normalised frames [lo, hi) of x (dim 2) from `stats`, in
        fp32 and rounded to x's dtype (`zq`: SpatialNorm3D's signature)."""
        scale, shift = stats
        bshape = scale.shape + (1,) * (x.dim() - 2)
        xf = x[:, :, lo:hi].to(torch.float32, copy=True)
        return xf.mul_(scale.view(bshape)).add_(shift.view(bshape)).to(x.dtype)


class SpatialNorm3D(nn.Module):
    """Decoder norm modulated by the latent zq (CogVideoXSpatialNorm3D)."""

    def __init__(self, features: int, zq_channels: int, groups: int = 32, **kw):
        super().__init__()
        self.norm_layer = GroupNorm(groups, features, dtype=kw["dtype"])
        self.conv_y = CausalConv3d(zq_channels, features, (1, 1, 1), **kw)
        self.conv_b = CausalConv3d(zq_channels, features, (1, 1, 1), **kw)

    @staticmethod
    def _zq_frames(zq, t: int, h: int, w: int, lo: int = 0, hi: Optional[int] = None):
        """zq resized to frames [lo, hi) of a [t, h, w] activation: frame
        0 to frame 0 and the rest spread over the rest at an odd t, else
        spread evenly; nearest in space."""
        hi = t if hi is None else hi
        zt = zq.shape[2]
        if zt != t:
            dev = zq.device
            if t > 1 and t % 2 == 1 and zt > 1:
                idx = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                                 1 + torch.arange(t - 1, device=dev) * (zt - 1) // (t - 1)])
            else:
                idx = torch.arange(t, device=dev) * zt // t
            zq = zq[:, :, idx[lo:hi]]
        elif (lo, hi) != (0, t):
            zq = zq[:, :, lo:hi]
        if zq.shape[3] != h:
            zq = F.interpolate(zq, size=(zq.shape[2], h, w), mode="nearest")
        return zq

    def forward(self, x, zq):
        zq = self._zq_frames(zq, *x.shape[2:])
        out = self.norm_layer(x)                    # a fresh tensor
        if torch.is_grad_enabled():
            return out * self.conv_y(zq) + self.conv_b(zq)
        return out.mul_(self.conv_y(zq)).add_(self.conv_b(zq))

    def stats(self, x):
        return self.norm_layer.stats(x)

    def apply_frames(self, x, lo: int, hi: int, stats, zq):
        """This norm's output frames [lo, hi) of x from `stats`
        (`GroupNorm.apply_frames`), modulated by zq's frames."""
        zs = self._zq_frames(zq, *x.shape[2:], lo, hi)
        return self.norm_layer.apply_frames(x, lo, hi, stats).mul_(self.conv_y(zs)).add_(
            self.conv_b(zs))


class ResnetBlock3D(nn.Module):
    def __init__(self, in_features: int, out_features: int, zq_channels: Optional[int] = None,
                 groups: int = 32, **kw):
        super().__init__()
        self.zq = zq_channels is not None
        if self.zq:
            self.norm1 = SpatialNorm3D(in_features, zq_channels, groups, **kw)
            self.norm2 = SpatialNorm3D(out_features, zq_channels, groups, **kw)
        else:
            self.norm1 = GroupNorm(groups, in_features, dtype=kw["dtype"])
            self.norm2 = GroupNorm(groups, out_features, dtype=kw["dtype"])
        self.conv1 = CausalConv3d(in_features, out_features, **kw)
        self.conv2 = CausalConv3d(out_features, out_features, **kw)
        self.conv_shortcut = (CausalConv3d(in_features, out_features, (1, 1, 1), **kw)
                              if in_features != out_features else None)

    def forward(self, x, zq=None):
        if not torch.is_grad_enabled() and x.numel() > SLICE_ELEMENTS:
            return self._streamed(x, zq)
        norm = (lambda m, h: m(h, zq)) if self.zq else (lambda m, h: m(h))
        inplace = not torch.is_grad_enabled()      # the norms' outputs are fresh
        h = self.conv1(F.silu(norm(self.norm1, x), inplace=inplace))
        h = self.conv2(F.silu(norm(self.norm2, h), inplace=inplace))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h.add_(x) if inplace else x + h

    def _streamed(self, x, zq):
        """The same function without autograd, holding x and the output
        whole and nothing else: each conv's input made a slice at a time
        (norm, modulation, SiLU), conv2 written over conv1's output, the
        shortcut added a slice at a time."""
        t = x.shape[2]
        act = lambda norm, src, stats: lambda lo, hi: F.silu(
            norm.apply_frames(src, lo, hi, stats, zq), inplace=True)
        h = self.conv1.stream(act(self.norm1, x, self.norm1.stats(x)), t, x[:, :, :1].numel())
        self.conv2.stream(act(self.norm2, h, self.norm2.stats(h)), t, h[:, :, :1].numel(), out=h)
        if self.conv_shortcut is None:
            return h.add_(x)
        step = max(1, SLICE_ELEMENTS // x[:, :, :1].numel())
        for a in range(0, t, step):
            h[:, :, a:a + step].add_(self.conv_shortcut(x[:, :, a:a + step]))
        return h


def _temporal_avg_pool(x):
    """Causal temporal 2x pool (dim 2) with odd-first-frame passthrough."""
    if x.shape[2] % 2 == 1:
        first, rest = x[:, :, :1], x[:, :, 1:]
        if rest.shape[2] > 0:
            rest = 0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])
        return torch.cat([first, rest], dim=2)
    return 0.5 * (x[:, :, 0::2] + x[:, :, 1::2])


class Downsample3D(nn.Module):
    """Spatial stride-2 conv (pad right/bottom), optional temporal pool."""

    def __init__(self, features: int, compress_time: bool = False, **kw):
        super().__init__()
        self.compress_time = compress_time
        self.conv = _Conv(features, features, (1, 3, 3), stride=(1, 2, 2), **kw)

    def forward(self, x):
        if self.compress_time:
            x = _temporal_avg_pool(x)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample3D(nn.Module):
    """Nearest 2x spatial (and causal 2t-1 temporal) upsample + conv."""

    def __init__(self, features: int, compress_time: bool = False, **kw):
        super().__init__()
        self.compress_time = compress_time
        self.conv = _Conv(features, features, (1, 3, 3), padding=(0, 1, 1), **kw)

    def forward(self, x):
        if self.compress_time and x.shape[2] > 1:
            if x.shape[2] % 2 == 1:
                x = torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
            else:
                x = x.repeat_interleave(2, dim=2)
        up = lambda v: self.conv(F.interpolate(v, scale_factor=(1, 2, 2), mode="nearest"))
        if torch.is_grad_enabled() or 4 * x.numel() <= SLICE_ELEMENTS:
            return up(x)
        # the spatial upsample and the (1, 3, 3) conv are per frame: a few
        # frames at a time into one output
        t = x.shape[2]
        step = max(1, SLICE_ELEMENTS // (4 * x[:, :, :1].numel()))
        out = None
        for a in range(0, t, step):
            ys = up(x[:, :, a:a + step])
            if out is None:
                out = ys.new_empty(ys.shape[:2] + (t,) + ys.shape[3:])
            out[:, :, a:a + step] = ys
        return out


def _norm_silu_conv(norm, conv, h, zq=None):
    """conv(silu(norm(h))) (norm(h, zq) for a SpatialNorm3D); without
    autograd over more than `SLICE_ELEMENTS` elements the conv's input is
    made a slice at a time, as in a resnet block."""
    if not torch.is_grad_enabled() and h.numel() > SLICE_ELEMENTS:
        stats = norm.stats(h)
        frames = lambda lo, hi: F.silu(norm.apply_frames(h, lo, hi, stats, zq), inplace=True)
        return conv.stream(frames, h.shape[2], h[:, :, :1].numel())
    out = norm(h) if zq is None else norm(h, zq)
    return conv(F.silu(out, inplace=not torch.is_grad_enabled()))


class Encoder3D(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        kw = dict(compute_dtype=c.dtype, dtype=c.param_dtype)
        levels = int(math.log2(c.temporal_compression_ratio))
        boc, n = c.block_out_channels, len(c.block_out_channels)
        self.conv_in = CausalConv3d(c.in_channels, boc[0], **kw)
        self.order = []
        cur = boc[0]
        for i, ch in enumerate(boc):
            for j in range(c.layers_per_block):
                self._add(f"down_{i}_res_{j}", ResnetBlock3D(cur, ch, None, c.norm_num_groups, **kw))
                cur = ch
            if i < n - 1:
                self._add(f"down_{i}_downsample", Downsample3D(ch, i < levels, **kw))
        for j in range(2):
            self._add(f"mid_res_{j}", ResnetBlock3D(cur, cur, None, c.norm_num_groups, **kw))
        self.norm_out = GroupNorm(c.norm_num_groups, cur, dtype=c.param_dtype)
        self.conv_out = CausalConv3d(cur, 2 * c.latent_channels, **kw)

    def _add(self, name, mod):
        self.add_module(name, mod)
        self.order.append(name)

    def forward(self, x):
        h = self.conv_in(x)
        for name in self.order:
            h = getattr(self, name)(h)
        return _norm_silu_conv(self.norm_out, self.conv_out, h)


class Decoder3D(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        kw = dict(compute_dtype=c.dtype, dtype=c.param_dtype)
        levels = int(math.log2(c.temporal_compression_ratio))
        rev = tuple(reversed(c.block_out_channels))
        zc, groups = c.latent_channels, c.norm_num_groups
        self.conv_in = CausalConv3d(zc, rev[0], **kw)
        self.order = []
        for j in range(2):
            self._add(f"mid_res_{j}", ResnetBlock3D(rev[0], rev[0], zc, groups, **kw))
        cur = rev[0]
        for i, ch in enumerate(rev):
            for j in range(c.layers_per_block + 1):
                self._add(f"up_{i}_res_{j}", ResnetBlock3D(cur, ch, zc, groups, **kw))
                cur = ch
            if i < len(rev) - 1:
                self._add(f"up_{i}_upsample", Upsample3D(ch, i < levels, **kw))
        self.norm_out = SpatialNorm3D(rev[-1], zc, groups, **kw)
        self.conv_out = CausalConv3d(rev[-1], c.out_channels, **kw)

    _add = Encoder3D._add

    def forward(self, z):
        h = self.conv_in(z)
        for name in self.order:
            mod = getattr(self, name)
            h = mod(h, z) if isinstance(mod, ResnetBlock3D) else mod(h)
        return _norm_silu_conv(self.norm_out, self.conv_out, h, z)


class CausalVAE(nn.Module):
    """Public API in the JAX layout ([B, T, C, H, W])."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder3D(cfg)
        self.decoder = Decoder3D(cfg)

    @classmethod
    def create(cls, cfg: VAEConfig = VAEConfig(), device: torch.device | str = "cuda",
               generator: Optional[torch.Generator] = None) -> "CausalVAE":
        """Build on `device` without touching the global RNG; weights drawn
        from `generator` when given, else left for `load_state_dict`."""
        with torch.device("meta"):
            model = cls(cfg)
        model = model.to_empty(device=device)
        if generator is not None:
            init_random_(model, generator)
        return model

    @classmethod
    def tiny(cls, device: torch.device | str = "cuda",
             generator: Optional[torch.Generator] = None) -> "CausalVAE":
        return cls.create(VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                                    latent_channels=4, norm_num_groups=4, dtype=torch.float32),
                          device=device, generator=generator)

    def encode_moments(self, video: torch.Tensor) -> torch.Tensor:
        """video [B, T, 3, H, W] in [-1, 1] -> moments [B, T', 2C, H/8, W/8]
        (mean, then logvar), fp32."""
        m = self.encoder(video.permute(0, 2, 1, 3, 4).to(self.cfg.dtype))
        return m.permute(0, 2, 1, 3, 4).float()

    def encode(self, video: torch.Tensor, sample: bool = False,
               generator: Optional[torch.Generator] = None,
               temporal_chunk: Optional[int] = None) -> torch.Tensor:
        """Scaled latents [B, T', C, H/8, W/8]: the posterior's mode, or with
        `sample` a draw mean + exp(logvar / 2) * eps, logvar clipped to
        [-30, 20], eps from `generator` (on the video's device).

        `temporal_chunk`: encode that many latent frames at a time with 2
        latent frames (their pixel frames) of left context, keeping the
        chunk's own frames (the JAX chunking; approximate at the joins:
        group-norm statistics are per chunk)."""
        r = self.cfg.temporal_compression_ratio
        t_px = video.shape[1]
        t_lat = (t_px - 1) // r + 1
        if temporal_chunk is None or t_lat <= temporal_chunk:
            mean, logvar = self.encode_moments(video).chunk(2, dim=2)
            if sample:
                if generator is None:
                    raise ValueError("sampling the posterior needs a generator")
                eps = torch.randn(mean.shape, generator=generator, device=mean.device)
                mean = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps
            return mean * self.cfg.scaling_factor
        outs, i, ctx = [], 0, 2
        while i < t_lat:
            k = min(temporal_chunk, t_lat - i)
            lo = max(0, i - ctx)
            # latent j > 0 owns pixel frames 4j-3 .. 4j; latent 0 owns frame 0
            px_lo = 0 if lo == 0 else r * lo - (r - 1)
            px_hi = min(t_px, r * (i + k - 1) + 1)
            outs.append(self.encode(video[:, px_lo:px_hi], sample, generator)[:, -k:])
            i += k
        return torch.cat(outs, dim=1)

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = (latents / self.cfg.scaling_factor).permute(0, 2, 1, 3, 4).to(self.cfg.dtype)
        return self.decoder(z).permute(0, 2, 1, 3, 4).float()

    def decode(self, latents: torch.Tensor, temporal_chunk: Optional[int] = None) -> torch.Tensor:
        """Scaled latents [B, T', C, h, w] -> video [B, T, 3, H, W].

        `temporal_chunk`: the concatenation of `decode_stream`'s chunks
        (approximate at the joins: group-norm statistics are per chunk).

        On the card a whole decode first hands the allocator's cached free
        blocks back: a 193-frame clip's largest activations take 32 GiB
        each, which the cached blocks of a denoise or an earlier decode
        could hold in pieces too small (`bench_vae_decode`)."""
        if temporal_chunk is None or latents.shape[1] <= temporal_chunk:
            if latents.is_cuda:
                torch.cuda.empty_cache()
            return self._decode(latents)
        return torch.cat([c for _, c in self.decode_stream(latents, temporal_chunk)], dim=1)

    def decode_stream(self, latents: torch.Tensor, temporal_chunk: Optional[int] = None
                      ) -> Iterator[Tuple[int, torch.Tensor]]:
        """Chunked `decode` as a generator (JAX `decode_stream`): yields
        `(start_pixel_frame, chunk [B, t, 3, H, W])` as each chunk of
        `temporal_chunk` latent frames finishes, with one latent frame of
        left context (dropped from the output); the first chunk takes
        `temporal_chunk + 1` frames and no context."""
        t_lat = latents.shape[1]
        if temporal_chunk is None or t_lat <= temporal_chunk:
            yield 0, self._decode(latents)
            return
        r, k = self.cfg.temporal_compression_ratio, temporal_chunk
        first = min(k + 1, t_lat)
        # an even-length first chunk decodes to 4t frames: keep the 4(t-1)+1 it owns
        yield 0, self._decode(latents[:, :first])[:, : r * (first - 1) + 1]
        pos, i = r * (first - 1) + 1, first
        while i < t_lat:
            n = min(k, t_lat - i)
            yield pos, self._decode(latents[:, i - 1:i + n])[:, 1:1 + r * n]
            pos, i = pos + r * n, i + n
