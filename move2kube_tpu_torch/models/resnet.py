"""ResNet-50 in PyTorch: the port of ``move2kube_tpu/models/resnet.py``.

Bottleneck blocks as the JAX model has them, NHWC at the edges (the
convolutions see the ``channels_last`` NCHW view inside), the
convolutions and BatchNorm in the config's ``dtype`` over fp32
parameters (BatchNorm's statistics in fp32, its result cast to the
model's type: the public flax ImageNet recipe the reference follows), a
fp32 classifier on the spatial mean. The stem's 7x7 stride-2
convolution pads ``(3, 3)`` and the max-pool ``(1, 1)``, symmetric; each
block's strided 3x3 convolution pads ``SAME``, which is ``(0, 1)`` over
an even size (:class:`~.layers.Conv`).

The running BatchNorm statistics are each norm's ``mean``/``var``
buffers (flax's ``batch_stats`` collection): a forward in training mode
normalises with the batch's statistics and updates them in place with
flax's momentum 0.9; ``model.eval()`` normalises with them, as
``train=False`` does in the JAX model.

Module names: ``stem_conv``/``stem_norm`` are the flax ``Conv_0``/
``BatchNorm_0``, ``blocks.{i}`` is ``BottleneckBlock_{i}`` with
``conv1..3``/``norm1..3`` (``Conv_0..2``/``BatchNorm_0..2``) and, in the
first block of each stage, ``proj_conv``/``proj_norm`` (``Conv_3``/
``BatchNorm_3``); ``head`` is ``Dense_0``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.layers import BatchNorm, Conv, Dense


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                        dtype=dtype)


def resnet18_ish(num_classes: int = 1000,
                 dtype=torch.bfloat16) -> ResNetConfig:
    """Small variant for tests (still bottleneck blocks)."""
    return ResNetConfig(stage_sizes=(1, 1, 1, 1), width=16,
                        num_classes=num_classes, dtype=dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int,
                 dtype: torch.dtype, project: bool) -> None:
        super().__init__()
        out = features * 4
        self.conv1 = Conv(in_ch, features, 1, dtype, bias=False)
        self.norm1 = BatchNorm(features, dtype)
        self.conv2 = Conv(features, features, 3, dtype, stride=strides,
                          bias=False)
        self.norm2 = BatchNorm(features, dtype)
        self.conv3 = Conv(features, out, 1, dtype, bias=False)
        self.norm3 = BatchNorm(out, dtype)
        self.project = project
        if project:
            self.proj_conv = Conv(in_ch, out, 1, dtype, stride=strides,
                                  bias=False)
            self.proj_norm = BatchNorm(out, dtype)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = (self.proj_norm(self.proj_conv(x)) if self.project
                    else x)
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """``x [b, H, W, 3] -> logits [b, num_classes]`` (fp32). Parameters
    (fp32) and the BatchNorm buffers are made on ``device``, the card by
    default (weights: :func:`~move2kube_tpu_torch.models.convert.
    init_family` or a ``state_dict``)."""

    def __init__(self, cfg: ResNetConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        dt, w = cfg.dtype, cfg.width
        with torch.device(resolve_device(device)):
            self.stem_conv = Conv(3, w, 7, dt, stride=2, padding=3,
                                  bias=False)
            self.stem_norm = BatchNorm(w, dt)
            blocks, in_ch = [], w
            for i, n_blocks in enumerate(cfg.stage_sizes):
                for j in range(n_blocks):
                    strides = 2 if i > 0 and j == 0 else 1
                    blocks.append(BottleneckBlock(in_ch, w * 2 ** i, strides,
                                                  dt, project=j == 0))
                    in_ch = w * 2 ** i * 4
            self.blocks = nn.ModuleList(blocks)
            self.head = Dense(in_ch, cfg.num_classes, torch.float32)

    def forward(self, x):
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.relu(self.stem_norm(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))
