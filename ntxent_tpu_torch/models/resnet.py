"""ResNet (v1.5) encoders for SimCLR, counterpart of
``ntxent_tpu/models/resnet.py``.

Same dtype policy: fp32 parameters, convolutions and activations in
``dtype`` (bf16 by default), BatchNorm statistics in fp32
(``layers.BatchNorm``, flax's momentum 0.9, epsilon 1e-5, two-pass
variance; across ranks once ``layers.cross_replica_batch_norm`` gives it
a process group, flax's ``axis_name``), a float32 pooled output. The
input is (B, H, W, C), as in the JAX package, permuted once to the
(B, C, H, W) view of the same memory (channels-last, which cuDNN takes
as it is).

Convolutions and the max-pool pad as flax's ``"SAME"`` does, which is
asymmetric for a strided window: ``total = max((out - 1) s + k - in, 0)``
with ``out = ceil(in / s)``, ``lo = total // 2`` before and ``hi = total -
lo`` after. The 7x7/2 stem on 224 pads (2, 3), the 3x3/2 max-pool on 112
pads (0, 1) with -inf, and each 3x3/2 convolution of a bottleneck pads
(0, 1). PyTorch's symmetric ``padding=`` would give outputs of the same
size over shifted windows.

* ``BottleneckBlock`` (1x1, 3x3 with the stride, 1x1 x4) and
  ``BasicBlock`` (3x3 with the stride, 3x3), each with the last
  BatchNorm's scale initialized to 0 and a 1x1 projection shortcut where
  the shape changes;
* the ImageNet stem (7x7/2 conv, BatchNorm, ReLU, 3x3/2 max-pool) or, with
  ``small_images``, the CIFAR stem (3x3/1 conv, BatchNorm, ReLU);
* ``stem="space_to_depth"`` (``SpaceToDepthStem``, ``resnet.py:31-80``):
  the same 7x7/2 stem computed as a 4x4/1 convolution of the image
  space-to-depth'd by 2, from the same (out, in, 7, 7) weight, so
  checkpoints interchange with the conv stem;
* ``ResNet18/34/50/50x2/101/152``; ``hidden_dim`` is the pooled width.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, lecun_normal_

__all__ = ["BasicBlock", "BottleneckBlock", "Conv", "ResNet", "ResNet18",
           "ResNet34", "ResNet50", "ResNet50x2", "ResNet101", "ResNet152",
           "SpaceToDepthStem", "same_padding", "space_to_depth"]


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of flax/XLA ``"SAME"`` along one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0):
    """``(x, (pad_h, pad_w))``: where flax's SAME padding is the same on
    both sides it is left to the operator (``padding=``, no copy of x);
    otherwise x comes back padded and the operator pads nothing."""
    top, bottom = same_padding(x.shape[2], kernel, stride)
    left, right = same_padding(x.shape[3], kernel, stride)
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")`` over (B, C, H, W),
    computed in ``dtype``; the weight is (out, in, k, k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = _pad_same(x.to(self.dtype), self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=padding)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, b*b*C, H/b, W/b) with the channels in
    ``(a, b, c)`` phase-major order, ``out[:, (a*b + b')*C + c, i, j] =
    x[:, c, b*i + a, b*j + b']``: the NCHW view of the JAX package's NHWC
    ``_space_to_depth`` (``resnet.py:31``)."""
    bsz, c, h, w = x.shape
    x = x.reshape(bsz, c, h // block, block, w // block, block)
    # (B, c, i, a, j, b') -> (B, a, b', c, i, j)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(
        bsz, block * block * c, h // block, w // block)


class SpaceToDepthStem(Conv):
    """The ImageNet 7x7/2 stem convolution as a 4x4/1 convolution of the
    space-to-depth'd image (``resnet.py:38-80``), the MLPerf TPU layout of
    the same linear map.

    The parameter stays the conv stem's (out, in, 7, 7) weight. Per apply
    it is padded to 8x8 and phase-grouped into (out, 4 in, 4, 4) in the
    ``(a, b, c)`` order ``space_to_depth`` gives the channels:
    ``w'[o, (a, b, c), ki, kj] = w[o, c, 2 ki + a, 2 kj + b]`` (zero at the
    padded 8th row and column). The image pads (1, 2) in H and W, the s2d
    image of the conv stem's SAME (2, 3) at 224. The convolution is
    cuDNN's, as ``lax.conv_general_dilated`` is XLA's in the JAX package.
    """

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_ch, out_ch, 7, 2, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] % 2 or x.shape[3] % 2:
            raise ValueError(f"space-to-depth stem needs even H/W, got "
                             f"{tuple(x.shape[2:])}")
        w = F.pad(self.weight, (0, 1, 0, 1))  # (out, in, 8, 8)
        o, c = w.shape[:2]
        # (o, c, ki, a, kj, b) -> (o, a, b, c, ki, kj)
        w = w.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        w = w.reshape(o, 4 * c, 4, 4).to(self.dtype)
        xs = F.pad(space_to_depth(x.to(self.dtype)), (1, 2, 1, 2))
        return F.conv2d(xs, w)


class _Block(nn.Module):
    """A residual block: its convolutions (``convs``), each followed by a
    norm (``norms``) and, but for the last, a ReLU; and the projection
    shortcut (``proj_conv``, ``proj_bn``) where the input's shape is not
    the output's."""

    expansion = 1

    def __init__(self, convs, in_ch: int, out_ch: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(
            BatchNorm(c.weight.shape[0], zero_init=i == len(convs) - 1)
            for i, c in enumerate(convs))
        self.proj_conv = self.proj_bn = None
        if in_ch != out_ch or stride != 1:
            self.proj_conv = Conv(in_ch, out_ch, 1, stride, dtype)
            self.proj_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        last = len(self.convs) - 1
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y)).to(self.dtype)
            if i < last:
                y = F.relu(y)
        residual = x
        if self.proj_conv is not None:
            residual = self.proj_bn(self.proj_conv(x)).to(self.dtype)
        return F.relu(y + residual)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__([Conv(in_ch, filters, 1, dtype=dtype),
                          Conv(filters, filters, 3, stride, dtype),
                          Conv(filters, 4 * filters, 1, dtype=dtype)],
                         in_ch, 4 * filters, stride, dtype)


class BasicBlock(_Block):
    def __init__(self, in_ch: int, filters: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__([Conv(in_ch, filters, 3, stride, dtype),
                          Conv(filters, filters, 3, dtype=dtype)],
                         in_ch, filters, stride, dtype)


class ResNet(nn.Module):
    """Pooled (B, hidden_dim) fp32 features of (B, H, W, C) images; no
    classifier."""

    def __init__(self, stage_sizes, block_cls=BottleneckBlock,
                 width_multiplier: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 small_images: bool = False, stem: str = "conv",
                 in_channels: int = 3):
        super().__init__()
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}: expected 'conv' or "
                             "'space_to_depth'")
        if small_images and stem != "conv":
            raise ValueError(f"stem={stem!r} requires the ImageNet stem; "
                             "small_images=True uses the 3x3 CIFAR stem "
                             "and would silently ignore it")
        self.dtype = dtype
        self.small_images = small_images
        width = 64 * width_multiplier
        if small_images:
            self.stem_conv = Conv(in_channels, width, 3, dtype=dtype)
        elif stem == "space_to_depth":
            self.stem_conv = SpaceToDepthStem(in_channels, width, dtype)
        else:
            self.stem_conv = Conv(in_channels, width, 7, 2, dtype)
        self.stem_bn = BatchNorm(width)
        blocks, in_ch = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(in_ch, width * 2**i, stride, dtype))
                in_ch = width * 2**i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.hidden_dim = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW
        x = F.relu(self.stem_bn(self.stem_conv(x)).to(self.dtype))
        if not self.small_images:
            x, padding = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, padding=padding)
        for block in self.blocks:
            x = block(x)
        # flax: jnp.mean in the activation dtype (fp32 accumulation), then
        # the cast to fp32
        return x.float().mean(dim=(2, 3)).to(self.dtype).float()


ResNet18 = partial(ResNet, (2, 2, 2, 2), BasicBlock)
ResNet34 = partial(ResNet, (3, 4, 6, 3), BasicBlock)
ResNet50 = partial(ResNet, (3, 4, 6, 3), BottleneckBlock)
ResNet101 = partial(ResNet, (3, 4, 23, 3), BottleneckBlock)
ResNet152 = partial(ResNet, (3, 8, 36, 3), BottleneckBlock)
ResNet50x2 = partial(ResNet, (3, 4, 6, 3), BottleneckBlock,
                     width_multiplier=2)
