"""ParseNet: the layout-detection U-Net, and OrientationNet (port of
pero_ocr_tpu/models/parsenet.py).

Same 5-channel output map contract as the JAX model:

    0: ascender height (px, at map resolution)   softplus
    1: descender height                          softplus
    2: baseline probability                      sigmoid
    3: line-endpoint probability                 sigmoid
    4: region-separator probability              sigmoid

The public boundary is NHWC, as in the JAX package: ``forward`` takes
(N, H, W, 3) images in [0, 1] and returns (N, H*U, W*U, 5) float32
maps.  Inside, the layers run NCHW in ``dtype`` (bfloat16 by default,
as the JAX model); the 1x1 output conv runs in float32.

OrientationNet shares the U-Net body (GroupNorm on every level) and
returns (N, H, W, 2) float32 raw (x, y) text directions from a float32
1x1 head.

Padding follows flax ``'SAME'``: the stride-2 downsampling conv on an
even input pads (0, 1), not torch's symmetric (1, 1).  GroupNorm uses
flax's epsilon 1e-6.  The transposed convs are torch
``ConvTranspose2d`` (kernel 2, stride 2); the converter in
:mod:`pero_ocr_tpu_torch.utils.convert` flips flax's
``transpose_kernel=False`` kernels to match.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

GROUP_NORM_EPS = 1e-6  # flax.linen.GroupNorm default


def same_pads(size: int, kernel: int, stride: int):
    """(low, high) padding of lax ``'SAME'`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d with lax ``'SAME'`` padding (asymmetric where lax pads
    asymmetrically)."""

    def forward(self, x):
        ph = same_pads(x.shape[2], self.kernel_size[0], self.stride[0])
        pw = same_pads(x.shape[3], self.kernel_size[1], self.stride[1])
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride, (ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride)


def group_norm(features: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(8, features), features, eps=GROUP_NORM_EPS)


class ConvBlock(nn.Module):
    """conv3x3 -> [GroupNorm] -> relu, twice."""

    def __init__(self, in_features: int, features: int, use_norm: bool = True):
        super().__init__()
        self.conv0 = SameConv2d(in_features, features, 3)
        self.norm0 = group_norm(features) if use_norm else nn.Identity()
        self.conv1 = SameConv2d(features, features, 3)
        self.norm1 = group_norm(features) if use_norm else nn.Identity()

    def forward(self, x):
        x = F.relu(self.norm0(self.conv0(x)))
        return F.relu(self.norm1(self.conv1(x)))


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, C*b*b, H/b, W/b), with the channel order of
    the JAX NHWC rearrangement: channel = (dy * b + dx) * C + c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(
        b, c * block * block, h // block, w // block
    )


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every parameter of ``module`` from ``generator``:
    He-normal conv/linear kernels, zero biases, unit norm scales,
    uniform(+-1/sqrt(H)) LSTM weights, normal embeddings."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = m.weight[0].numel() if not isinstance(
                    m, nn.ConvTranspose2d
                ) else m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.LSTM):
                bound = m.hidden_size ** -0.5
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)


def build_unet(net: nn.Module, in_c: int, features: int, n_levels: int,
               down_norm, up_norm) -> int:
    """Give ``net`` the U-Net's modules (``down_blocks``, ``down_convs``,
    ``bottleneck``, ``up_convs``, ``up_blocks``, the flax module order):
    ``n_levels`` levels from ``features`` channels, doubling down;
    ``down_norm(level)`` and ``up_norm(level)`` say which ConvBlocks
    carry GroupNorm.  Returns the output channels."""
    net.down_blocks = nn.ModuleList()
    net.down_convs = nn.ModuleList()
    for level in range(n_levels):
        net.down_blocks.append(ConvBlock(in_c, features, use_norm=down_norm(level)))
        net.down_convs.append(SameConv2d(features, features, 3, stride=2))
        in_c = features
        features *= 2
    net.bottleneck = ConvBlock(in_c, features)
    net.up_convs = nn.ModuleList()
    net.up_blocks = nn.ModuleList()
    for level in range(n_levels):
        features //= 2
        net.up_convs.append(nn.ConvTranspose2d(2 * features, features, 2, 2))
        net.up_blocks.append(ConvBlock(2 * features, features, use_norm=up_norm(level)))
    return features


def unet(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The body :func:`build_unet` gave ``net``, on NCHW ``x``."""
    skips = []
    for block, down in zip(net.down_blocks, net.down_convs):
        x = block(x)
        skips.append(x)
        x = down(x)
    x = net.bottleneck(x)
    for up, block, skip in zip(net.up_convs, net.up_blocks, reversed(skips)):
        x = block(torch.cat([up(x), skip], dim=1))
    return x


class ParseNet(nn.Module):
    """U-Net emitting the 5-channel layout map stack (see module doc).

    ``stem="s2d"``: a 2x2 space-to-depth moves the first level to half
    resolution and a thin full-resolution head (one transposed conv and
    one 3x3 conv at ``head_features``) restores it.  ``out_upsample``
    (a power of two) adds one such thin level per octave above the
    input resolution."""

    def __init__(
        self,
        base_features: int = 32,
        depth: int = 4,
        out_channels: int = 5,
        dtype: torch.dtype = torch.bfloat16,
        stem: str = "conv",
        head_features: int = 8,
        out_upsample: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(f"stem={stem!r} must be 'conv' or 's2d'")
        up = out_upsample
        if up & (up - 1) or up < 1:
            raise ValueError(f"out_upsample={up} must be a power of two")
        self.stem = stem
        self.out_upsample = out_upsample
        self.dtype = dtype
        if stem == "s2d":
            features, n_levels, in_c = base_features * 2, depth - 1, 12
        else:
            features, n_levels, in_c = base_features, depth, 3
        features = build_unet(self, in_c, features, n_levels, lambda level: level > 0,
                              lambda level: level < n_levels - 1)
        # Thin head levels: the s2d stem's return to input resolution,
        # then one per super-resolving octave.
        n_head = (stem == "s2d") + (out_upsample.bit_length() - 1)
        self.head_ups = nn.ModuleList()
        self.head_convs = nn.ModuleList()
        in_c = features
        for _ in range(n_head):
            self.head_ups.append(nn.ConvTranspose2d(in_c, head_features, 2, 2))
            self.head_convs.append(SameConv2d(head_features, head_features, 3))
            in_c = head_features
        self.to(dtype)
        self.out = nn.Conv2d(in_c, out_channels, 1)  # float32
        if generator is not None:
            init_weights_(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (N, H, W, 3) float in [0, 1]; H, W multiples of
        2**depth.  Returns (N, H*U, W*U, 5) float32 maps (NHWC)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = unet(self, x)
        for up, conv in zip(self.head_ups, self.head_convs):
            x = F.relu(conv(F.relu(up(x))))
        x = self.out(x.float())
        x = torch.cat([F.softplus(x[:, :2]), torch.sigmoid(x[:, 2:])], dim=1)
        return x.permute(0, 2, 3, 1)


class OrientationNet(nn.Module):
    """Per-pixel text-direction (x, y) map (JAX ``OrientationNet``): the
    U-Net at ``base_features`` and ``depth`` with GroupNorm on every
    level, and a float32 1x1 head with no activation (consumers take
    arctan2, so the magnitude carries no meaning)."""

    def __init__(self, base_features: int = 16, depth: int = 3,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        features = build_unet(self, 3, base_features, depth, lambda level: True,
                              lambda level: True)
        self.to(dtype)
        self.out = nn.Conv2d(features, 2, 1)  # float32
        if generator is not None:
            init_weights_(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (N, H, W, 3) float in [0, 1]; H, W multiples of
        2**depth.  Returns (N, H, W, 2) float32 directions (NHWC)."""
        x = unet(self, images.permute(0, 3, 1, 2).to(self.dtype))
        return self.out(x.float()).permute(0, 2, 3, 1)
