"""Diffusion UNet (DDPM noise predictor) in PyTorch: the port of
``move2kube_tpu/models/unet.py``.

The JAX model's architecture: a sinusoidal timestep embedding through a
two-layer fp32 MLP; a down path of residual conv blocks with a
timestep-conditioned shift and strided-conv downsampling; a bottleneck
with single-head global self-attention over the spatial tokens (plain
einsums in fp32, as the reference computes them: no Pallas kernel runs
here, so none is ported); an up path with skip concatenation and
nearest-neighbour upsampling at exactly 2x. NHWC at the edges; the
convolutions see the ``channels_last`` NCHW view inside and run in the
config's ``dtype`` over fp32 parameters, GroupNorm (epsilon 1e-6,
flax's default) in fp32. The strided ``down_{li}_pool`` convolution pads
``SAME``, ``(0, 1)`` over an even size (:class:`~.layers.Conv`).

Module names are the flax ones (``time_mlp1``, ``conv_in``,
``down_{li}_{bi}``, ``down_{li}_pool``, ``mid_1``, ``mid_attn``,
``mid_2``, ``up_{li}_{bi}``, ``up_{li}_unpool``, ``norm_out``,
``conv_out``; a block's ``norm1``, ``conv1``, ``time_proj``, ``norm2``,
``conv2``, ``skip_proj``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.layers import Conv, Dense, GroupNorm


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    base_channels: int = 128
    channel_mults: tuple = (1, 2, 2)
    num_res_blocks: int = 2
    time_dim: int = 512
    norm_groups: int = 32
    dtype: torch.dtype = torch.bfloat16


def unet_small() -> UNetConfig:
    """CIFAR-scale DDPM UNet (~35M params)."""
    return UNetConfig()


def unet_tiny() -> UNetConfig:
    """Small variant for tests."""
    return UNetConfig(base_channels=16, channel_mults=(1, 2),
                      num_res_blocks=1, time_dim=32, norm_groups=4)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings (``[b]`` integer -> ``[b, dim]``), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def ddpm_alpha_bars(num_steps: int = 1000, beta_start: float = 1e-4,
                    beta_end: float = 0.02, device=None):
    """Cumulative noise schedule (linear betas, DDPM defaults), fp32."""
    betas = torch.linspace(beta_start, beta_end, num_steps,
                           dtype=torch.float32, device=device)
    return torch.cumprod(1.0 - betas, dim=0)


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> Conv, twice, with a timestep-conditioned shift
    between; an identity (or 1x1-projected) residual."""

    def __init__(self, in_ch: int, channels: int, cfg: UNetConfig) -> None:
        super().__init__()
        dt = cfg.dtype
        groups = min(cfg.norm_groups, channels)
        self.norm1 = GroupNorm(min(groups, in_ch), in_ch)
        self.conv1 = Conv(in_ch, channels, 3, dt)
        self.time_proj = Dense(cfg.time_dim, channels, dt)
        self.norm2 = GroupNorm(groups, channels)
        self.conv2 = Conv(channels, channels, 3, dt)
        self.skip = in_ch != channels
        if self.skip:
            self.skip_proj = Conv(in_ch, channels, 1, dt)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip:
            x = self.skip_proj(x)
        return x + h


class SpatialAttention(nn.Module):
    """Single-head global self-attention over the flattened spatial
    tokens (row-major, as the NHWC reshape orders them), in fp32."""

    def __init__(self, channels: int, cfg: UNetConfig) -> None:
        super().__init__()
        self.norm = GroupNorm(min(cfg.norm_groups, channels), channels)
        self.qkv = Dense(channels, 3 * channels, torch.float32)
        self.out = Dense(channels, channels, cfg.dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.qkv(tokens).split(c, dim=-1)
        p = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k) * c ** -0.5,
                          dim=-1)
        o = self.out(torch.einsum("bqk,bkc->bqc", p, v))
        return x + o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class UNet(nn.Module):
    """``x [b, H, W, C]`` noisy images, ``t [b]`` integer timesteps ->
    predicted noise ``[b, H, W, C]`` (fp32). Parameters (fp32) are made on
    ``device``, the card by default (weights: :func:`~move2kube_tpu_torch.
    models.convert.init_family` or a ``state_dict``)."""

    def __init__(self, cfg: UNetConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        dt, base = cfg.dtype, cfg.base_channels
        mults = cfg.channel_mults
        with torch.device(resolve_device(device)):
            self.time_mlp1 = Dense(cfg.time_dim, cfg.time_dim, torch.float32)
            self.time_mlp2 = Dense(cfg.time_dim, cfg.time_dim, torch.float32)
            self.conv_in = Conv(cfg.in_channels, base, 3, dt)
            chans = [base]  # channels of each skip, in push order
            ch = base
            for li, mult in enumerate(mults):
                for bi in range(cfg.num_res_blocks):
                    self.add_module(f"down_{li}_{bi}",
                                    ResBlock(ch, base * mult, cfg))
                    ch = base * mult
                    chans.append(ch)
                if li != len(mults) - 1:
                    self.add_module(f"down_{li}_pool",
                                    Conv(ch, ch, 3, dt, stride=2))
                    chans.append(ch)
            self.mid_1 = ResBlock(ch, ch, cfg)
            self.mid_attn = SpatialAttention(ch, cfg)
            self.mid_2 = ResBlock(ch, ch, cfg)
            for li, mult in reversed(list(enumerate(mults))):
                for bi in range(cfg.num_res_blocks + 1):
                    self.add_module(f"up_{li}_{bi}", ResBlock(
                        ch + chans.pop(), base * mult, cfg))
                    ch = base * mult
                if li != 0:
                    self.add_module(f"up_{li}_unpool", Conv(ch, ch, 3, dt))
            self.norm_out = GroupNorm(min(cfg.norm_groups, ch), ch)
            self.conv_out = Conv(ch, cfg.in_channels, 3, torch.float32)

    def forward(self, x, t):
        cfg = self.cfg
        mults = cfg.channel_mults
        temb = self.time_mlp1(timestep_embedding(t, cfg.time_dim))
        temb = self.time_mlp2(F.silu(temb))
        h = self.conv_in(x.permute(0, 3, 1, 2))  # NHWC -> NCHW view
        skips = [h]
        for li in range(len(mults)):
            for bi in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{li}_{bi}")(h, temb)
                skips.append(h)
            if li != len(mults) - 1:
                h = getattr(self, f"down_{li}_pool")(h)
                skips.append(h)
        h = self.mid_2(self.mid_attn(self.mid_1(h, temb)), temb)
        for li in reversed(range(len(mults))):
            for bi in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{li}_{bi}")(h, temb)
            if li != 0:
                # nearest at exactly 2x: each pixel repeated on H and W
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{li}_unpool")(h)
        h = F.silu(self.norm_out(h))
        return self.conv_out(h).permute(0, 2, 3, 1)
