"""TorchViT: the port of ``JaxViT``.

The counterpart of ``rafiki_tpu/models/vit.py:30-178``: a patchify
convolution at stride = patch (with bias, bf16), the CLS token, the
position table ``pos_embed`` (both f32 parameters, cast to bf16), and
``MAX_DEPTH`` = 6 encoder blocks (``transformer._EncoderBlock``) on
``default_attention`` (K1 on the card, non-causal, head_dim
d_model / n_heads; K2 and K3 for the gradient), each blended with its
input by the ``depth`` mask so a masked block is the identity; then the
f32 LayerNorm of the CLS token and an f32 head. flax convolves NHWC and
reshapes the (h, w) grid row-major into tokens; the port convolves NCHW
and permutes to NHWC before the reshape, so ``pos_embed`` lands on the
same patches.

Training is ``TorchModel``'s, with Adam under the cosine and the
``weight_decay`` knob coupled into the moments (ref :109-111;
``traced_knob_defaults`` as the reference's). Serving: members of one
width stack (``stack_signature``), K1 batched over the members
(``attention._Flash.vmap``); ``quantized_apply`` is the int8 forward:
the patch convolution on ``dynamic_int8_conv``, each block on
``quantized_encoder_block`` (K1 on f32 q, k and v), the f32 head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..model import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from ..model.torch_model import (TorchModel, dynamic_int8_conv,
                                 dynamic_int8_matmul)
from ..ops.attention import default_attention
from . import layers
from .layers import Conv, Dense, LayerNorm, cast
from .transformer import _EncoderBlock, quantized_encoder_block

MAX_DEPTH = 6  # supernet depth; the depth knob masks trailing blocks


class _ViT(nn.Module):
    def __init__(self, in_ch: int, n_classes: int, d_model: int,
                 n_heads: int, patch: int, n_tokens: int, seed: int,
                 max_depth: int = MAX_DEPTH):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.d_model, self.n_heads, self.patch = d_model, n_heads, patch
        self.max_depth = max_depth
        self.Conv_0 = Conv(in_ch, d_model, patch, gen, stride=patch,
                           use_bias=True)
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_embed = nn.Parameter(torch.empty(1, n_tokens, d_model))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
        for i in range(max_depth):
            setattr(self, f"_EncoderBlock_{i}",
                    _EncoderBlock(d_model, n_heads, gen))
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, n_classes, gen, f32=True)
        self.attention = default_attention(causal=False)

    def forward(self, x: torch.Tensor,
                depth: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, C) f32 images -> (B, n_classes) f32 logits."""
        h = self.Conv_0(x.permute(0, 3, 1, 2))
        b = h.shape[0]
        h = h.permute(0, 2, 3, 1).reshape(b, -1, self.d_model)
        h = torch.cat([cast(self.cls).expand(b, 1, self.d_model), h], dim=1)
        h = h + cast(self.pos_embed)
        for i in range(self.max_depth):
            y = getattr(self, f"_EncoderBlock_{i}")(h, self.attention)
            if depth is not None:
                y = h + depth[i].to(y.dtype) * (y - h)
            h = y
        return self.Dense_0(self.LayerNorm_0(h[:, 0]))


class TorchViT(TorchModel):
    """Vision Transformer; depth searched via a block mask."""

    traced_knob_defaults = {"learning_rate": 1e-3, "weight_decay": 1e-4}

    @staticmethod
    def get_knob_config():
        return {
            "depth": IntegerKnob(2, MAX_DEPTH),
            "d_model": FixedKnob(128),
            "n_heads": FixedKnob(4),
            "patch": FixedKnob(4),
            "learning_rate": FloatKnob(1e-4, 1e-2, is_exp=True),
            "batch_size": CategoricalKnob([64, 128, 256]),
            "weight_decay": FloatKnob(1e-5, 1e-3, is_exp=True),
            "max_epochs": IntegerKnob(3, 40),
            "early_stop_epochs": FixedKnob(5),
        }

    def _widths(self):
        return (int(self.knobs.get("d_model", 128)),
                int(self.knobs.get("n_heads", 4)),
                int(self.knobs.get("patch", 4)))

    def create_module(self, n_classes: int, image_shape: Sequence[int]):
        d_model, n_heads, patch = self._widths()
        h, w = int(image_shape[0]), int(image_shape[1])
        if h % patch or w % patch:
            raise ValueError(f"image {h}x{w} not divisible by "
                             f"patch {patch}")
        return _ViT(int(image_shape[-1]), n_classes, d_model, n_heads, patch,
                    1 + (h // patch) * (w // patch),
                    seed=int(self.knobs.get("seed", 0)))

    def extra_apply_inputs(self) -> Dict[str, np.ndarray]:
        depth = int(self.knobs.get("depth", MAX_DEPTH))
        return {"depth": (np.arange(MAX_DEPTH) < depth).astype(np.float32)}

    def module_config(self) -> Any:
        """What flax's ``_ViT`` compares: classes, widths, patch, tokens,
        the supernet depth and the compute dtype."""
        shape = self._meta.get("image_shape", [0, 0, 0])
        patch = self._widths()[2]
        return ("_ViT", int(self._meta.get("n_classes", 0)),
                *self._widths(),
                1 + (shape[0] // patch) * (shape[1] // patch), MAX_DEPTH,
                str(layers.COMPUTE))

    def stack_signature(self) -> Any:
        return (*super().stack_signature(), MAX_DEPTH)

    def quantized_apply(self, qvars, scales, fvars, x, extra):
        """int8 serving (ref :120-178): the patch convolution int8 ×
        int8 -> int32 (``dynamic_int8_conv``, ``VALID`` at stride =
        patch), each block ``quantized_encoder_block``, blended by the
        depth mask, the f32 LayerNorm of the CLS token and the head on
        ``dynamic_int8_matmul``; a kernel left in f32 runs in f32."""
        d_model, n_heads, patch = self._widths()
        k = "params/Conv_0/kernel"
        b = fvars["params/Conv_0/bias"].float()
        if k in qvars:
            h = dynamic_int8_conv(x, qvars[k], scales[k],
                                  strides=(patch, patch),
                                  padding="VALID") + b
        else:
            h = torch.nn.functional.conv2d(
                x.permute(0, 3, 1, 2), fvars[k].float().permute(3, 2, 0, 1),
                stride=patch).permute(0, 2, 3, 1) + b
        bsz = h.shape[0]
        h = h.reshape(bsz, -1, d_model)
        cls = fvars["params/cls"].float()
        h = torch.cat([cls.expand(bsz, 1, d_model), h], dim=1)
        h = h + fvars["params/pos_embed"].float()
        attn = default_attention(causal=False)
        depth = extra["depth"]
        for i in range(MAX_DEPTH):
            y = quantized_encoder_block(qvars, scales, fvars,
                                        f"params/_EncoderBlock_{i}", h, attn,
                                        n_heads)
            if y is None:
                return None
            h = h + depth[i].to(y.dtype) * (y - h)
        hf = torch.nn.functional.layer_norm(
            h[:, 0].float(), (d_model,),
            fvars["params/LayerNorm_0/scale"].float(),
            fvars["params/LayerNorm_0/bias"].float(), 1e-6)
        k = "params/Dense_0/kernel"
        b = fvars["params/Dense_0/bias"].float()
        if k in qvars:
            return dynamic_int8_matmul(hf, qvars[k], scales[k]) + b
        return hf @ fvars[k].float() + b
