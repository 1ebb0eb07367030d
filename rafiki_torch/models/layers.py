"""Layers of the conv zoo, computed as flax computes them.

PyTorch's modules differ from flax's in defaults that a parity test at
small sizes shows poorly, so the zoo builds on these instead:

- ``BatchNorm``: flax's ``BatchNorm(momentum=0.9, dtype=float32)``.
  Statistics in f32 over N, H and W; the running update
  ``ra = 0.9·ra + 0.1·batch`` with the *biased* batch variance; eps
  1e-5; an f32 output. In eval mode over stacked members (``stacked``)
  it is flax's formula ``(x − mean) · m + bias``, ``m = rsqrt(var +
  eps) · scale``, folded into one multiply-add a channel: ``x · m +
  (bias − mean · m)``. ``torch.nn.BatchNorm2d`` updates its running
  variance with the unbiased one, and its ``momentum`` is the other way
  round: the layer calls the library's kernel with momentum 1 into
  scratch buffers and makes flax's update from them.
- ``GroupNorm``: flax's ``GroupNorm(dtype=float32)``, eps **1e-6**
  (torch's default is 1e-5), statistics in f32 and an f32 output; the
  caller casts it back to bf16 as the reference does.
- ``Conv``: flax's ``Conv(dtype=bfloat16, use_bias=False)``, a bf16
  cast of the f32 kernel and a bf16 product; ``use_bias=True`` adds the
  bf16 cast of the bias to the bf16 product, as flax's default
  ``Conv`` does (ViT's patches, the VGG-style CNN). The kernel is held as
  torch's ``(out, in / groups, kh, kw)``; the bridge maps flax's HWIO.
  ``padding`` is symmetric: the 3×3 convolutions ask for 1 explicitly,
  and flax's ``SAME`` is ``k // 2`` for the stride-1 odd kernels here
  and 0 for every 1×1 kernel at any stride.
- ``avg_pool3``/``max_pool3``: flax's 3×3 stride-1 ``SAME`` pools; the
  average counts the zero padding (``count_include_pad``) and the max
  pads with −inf, as flax's do.
- ``dense``: flax's ``Dense(dtype=bfloat16)``, which rounds the product
  to bf16 before it adds the bf16 bias; ``Dense`` is the same as a
  module of its own, over any number of leading axes, with or without a
  bias and in f32 where flax's ``dtype`` is float32 (the transformer
  zoo's projections and heads).
- ``LayerNorm``: flax's ``LayerNorm(dtype=float32)``, eps **1e-6**,
  statistics and output in f32.
- ``Embed``: flax's ``Embed``; the rows of its table in ``dtype``
  (bf16 for the transformer tagger, f32 for the BiLSTM).

On a mesh (``parallel.data``) each data-parallel rank runs a replica of
the module. A ``Dense``, ``Conv`` or ``dense`` layer whose kernel is
split over ``tp`` computes each tp rank's slice of its output features
on that rank's device and joins them (``column``). A ``BatchNorm`` in
train mode with ``dp > 1`` normalises by the whole batch's moments: each
rank's per-channel sum and sum of squares added over the ranks
(``dp_sum``), the variance flax's ``E[x²] − E[x]²``; rank 0 alone
updates the running statistics, once a step, as one flax ``BatchNorm``
over the global batch does.

``COMPUTE`` is flax's ``dtype`` of these layers, bf16; ``cast`` casts
an activation to it. Modules take and give NCHW tensors. Parameters
start from flax's initialisers (a truncated LeCun-normal kernel; norm scale 1, bias 0),
drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

#: flax's lecun_normal: a normal of variance 1/fan_in truncated at two
#: standard deviations, rescaled by the truncation's std (0.8796...).
TRUNC_STD = 0.87962566103423978
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
GN_EPS = 1e-6
LN_EPS = 1e-6
#: The dtype of the convolutions, the dense products and the
#: activations between them (flax's ``dtype``); a test may set float32
#: to hold a train step against a float32 reference module.
COMPUTE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE)


def stacked(x: torch.Tensor) -> bool:
    """Whether ``x`` is a tensor of a ``torch.func.vmap`` over stacked
    members (``model.stacked``), where only the default memory format
    may be asked for."""
    return torch._C._functorch.is_batchedtensor(x)


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=gen)


def column(layer: nn.Module, x: torch.Tensor,
           fn: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                        torch.Tensor], dim: int = -1) -> torch.Tensor:
    """``fn(x, weight, bias)`` of ``layer``; on a rank's replica whose
    kernel is split over ``tp`` (its ``tp_shards``, ``(device, weight,
    bias)`` a tp rank), each tp rank's slice of the output features on
    its device, joined along ``dim`` on ``x``'s device: the reference's
    column parallelism and its all-gather of the activations."""
    shards = getattr(layer, "tp_shards", None)
    if shards is None:
        return fn(x, layer.weight, layer.bias)
    return torch.cat([fn(x.to(d, non_blocking=True), w, b).to(
        x.device, non_blocking=True) for d, w, b in shards], dim=dim)


def dense(layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=bfloat16)``: product and bias add in bf16."""
    return column(layer, h, lambda x, w, b: F.linear(cast(x), cast(w))
                  + cast(b))


def make_dense(in_features: int, out_features: int,
               gen: torch.Generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, in_features, gen)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class Conv(nn.Module):
    """flax ``Conv(dtype=bfloat16, use_bias=False)`` on NCHW input."""

    tp_shards = None  # set on a mesh's replica (``column``)

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 gen: torch.Generator, stride: int = 1, padding: int = 0,
                 groups: int = 1, use_bias: bool = False):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel))
        lecun_normal_(self.weight, in_ch // groups * kernel * kernel, gen)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def conv(x, w, b):
            y = F.conv2d(cast(x), cast(w), None, self.stride, self.padding,
                         1, self.groups)
            return y if b is None else y + cast(b).view(-1, 1, 1)

        if self.stride > 1 and x.requires_grad and x.device.type == "cpu" \
                and x.is_contiguous(memory_format=torch.channels_last) \
                and not x.is_contiguous():
            # The CPU build's oneDNN backward of a strided convolution of
            # a channels-last batch of 4 corrupts the heap (torch 2.13, a
            # 1×1 kernel at stride 2): the product runs on a contiguous
            # copy and its output goes back to channels-last.
            return column(self, x.contiguous(), conv, dim=1).contiguous(
                memory_format=torch.channels_last)
        return column(self, x, conv, dim=1)

    def macs(self, out: torch.Tensor) -> int:
        """Multiply-adds of one example whose output is ``out``."""
        o, i, kh, kw = self.weight.shape
        return int(out.shape[-2] * out.shape[-1] * o * i * kh * kw)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, dtype=float32)`` over NCHW."""

    #: A mesh's replica of it sums its moments over the ranks: its
    #: ``dp_sum``, and ``dp_writer`` on the rank that updates the
    #: running statistics.
    needs_dp_sum = True
    dp_sum = None
    dp_writer = False

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training and stacked(xf):
            # The library's kernel asks for the input's layout, which a
            # vmap over members cannot answer: flax's eval formula,
            # folded into one multiply-add a channel (one pass over x).
            view = (1, -1, 1, 1)
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            shift = self.bias - self.running_mean * mul
            return torch.addcmul(shift.view(view), xf, mul.view(view))
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        if self.dp_sum is not None:
            return self._whole_batch(xf, self.dp_sum)
        # The library's train-mode kernel normalises with the batch's
        # biased variance, as flax does. With momentum 1 it leaves the
        # batch mean and the *unbiased* variance in the scratch buffers;
        # the running update is flax's, on the biased variance.
        n = xf.numel() // xf.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(xf, mean, var, self.weight, self.bias, True, 1.0,
                         BN_EPS)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean * (1 - BN_MOMENTUM))
            self.running_var.mul_(BN_MOMENTUM).add_(
                var * ((1 - BN_MOMENTUM) * (n - 1) / n))
        return y

    def _whole_batch(self, xf: torch.Tensor, dp_sum) -> torch.Tensor:
        """Train mode on a rank of a mesh: the whole batch's mean and
        biased variance from every rank's sums (``dp_sum``), in f32;
        the running statistics updated by rank 0 alone."""
        view = (1, -1, 1, 1)
        # A fill, not a copy from the host: a captured step holds it.
        n = xf.new_full((1,), float(xf.numel() // xf.shape[1]))
        part = torch.cat([xf.sum(dim=(0, 2, 3)),
                          (xf * xf).sum(dim=(0, 2, 3)), n])
        total = dp_sum(part)
        c = xf.shape[1]
        count = total[2 * c]
        mean = total[:c] / count
        var = torch.clamp_min(total[c:2 * c] / count - mean * mean, 0.0)
        if self.dp_writer:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean.detach() * (1 - BN_MOMENTUM))
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var.detach() * (1 - BN_MOMENTUM))
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (xf - mean.view(view)) * mul.view(view) + self.bias.view(view)


class GroupNorm(nn.Module):
    """flax ``GroupNorm(dtype=float32)`` (eps 1e-6) over NCHW."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if stacked(x):
            x = x.contiguous()
        return F.group_norm(x, self.groups, self.weight, self.bias, GN_EPS)


def avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def max_pool3(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool(x, (3, 3), strides=(1, 1), padding="SAME")``."""
    return F.max_pool2d(x, 3, 1, 1)



class Dense(nn.Module):
    """flax ``Dense`` over the last axis: the kernel held as ``weight``
    ``(out, in)``, an optional ``bias``; ``f32`` computes in float32
    (flax's ``dtype=float32``), else in ``COMPUTE`` with the product
    rounded before the bias is added."""

    tp_shards = None  # set on a mesh's replica (``column``)

    def __init__(self, in_features: int, out_features: int,
                 gen: torch.Generator, use_bias: bool = True,
                 f32: bool = False):
        super().__init__()
        self.f32 = f32
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        lecun_normal_(self.weight, in_features, gen)
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        to = (lambda t: t.float()) if self.f32 else cast

        def linear(x, w, b):
            y = F.linear(to(x), to(w))
            return y if b is None else y + to(b)

        return column(self, x, linear)

    def macs(self, out: torch.Tensor) -> int:
        """Multiply-adds of one example whose output is ``out``."""
        return int(out.numel() * self.weight.shape[1])


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=float32)`` (eps 1e-6) over the last axis."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, LN_EPS)


class Embed(nn.Module):
    """flax ``Embed``: rows of the table (``weight``, the bridge's
    ``embedding``) in ``dtype``. flax's initialiser is a normal of
    variance 1/features."""

    def __init__(self, num: int, features: int, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(features),
                                generator=gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)
