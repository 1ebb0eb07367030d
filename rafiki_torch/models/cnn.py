"""TorchCnn: the port of ``JaxCnn``.

The counterpart of ``rafiki_tpu/models/cnn.py:30-153``: three stages of
64, 128 and 256 channels, each two 3×3 convolutions with bias and ReLU
(bf16, padding 1) and a 2×2 max pool, the trailing channels of every
stage zeroed by the ``width_16ths`` mask (a masked channel feeds zeros
forward and takes a zero gradient, so a trial's function is the exact
narrower net); then the NHWC flatten (the port permutes its NCHW
activations first), ``Dense`` 256 with ReLU in bf16 and an f32 head.
Training is ``TorchModel``'s: Adam under the cosine with the
``weight_decay`` knob coupled into the moments (ref :90-92). Serving:
members stack whatever their widths; ``quantized_apply`` runs every
convolution on ``dynamic_int8_conv`` (``((1, 1), (1, 1))`` padding) and
the two dense layers on ``dynamic_int8_matmul``, in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..model import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from ..model.torch_model import (TorchModel, dynamic_int8_conv,
                                 dynamic_int8_matmul)
from . import layers
from .layers import Conv, cast, column, dense, make_dense

MAX_WIDTH = 64   # stage-0 channels; stage i uses MAX_WIDTH * 2**i
N_STAGES = 3


class _Cnn(nn.Module):
    def __init__(self, in_ch: int, n_classes: int, image_hw: Sequence[int],
                 seed: int):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        h, w = int(image_hw[0]), int(image_hw[1])
        ch_in, n = in_ch, 0
        for stage in range(N_STAGES):
            ch = MAX_WIDTH * 2 ** stage
            for _ in range(2):
                setattr(self, f"Conv_{n}",
                        Conv(ch_in, ch, 3, gen, padding=1, use_bias=True))
                ch_in, n = ch, n + 1
            if min(h, w) >= 2:
                h, w = h // 2, w // 2
        self.Dense_0 = make_dense(h * w * ch_in, 256, gen)
        self.Dense_1 = make_dense(256, n_classes, gen)

    def forward(self, x: torch.Tensor,
                width_16ths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, C) f32 images -> (B, n_classes) f32 logits."""
        h = cast(x.permute(0, 3, 1, 2))
        n = 0
        for stage in range(N_STAGES):
            ch = MAX_WIDTH * 2 ** stage
            mask = None if width_16ths is None else cast(
                width_16ths.repeat_interleave(ch // 16)).view(-1, 1, 1)
            for _ in range(2):
                h = torch.relu(getattr(self, f"Conv_{n}")(h))
                if mask is not None:
                    h = h * mask
                n += 1
            if min(h.shape[-2], h.shape[-1]) >= 2:
                h = F.max_pool2d(h, 2, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = torch.relu(dense(self.Dense_0, h))
        return column(self.Dense_1, h.float(), F.linear)


class TorchCnn(TorchModel):
    """VGG-style CNN; width searched via a channel mask."""

    traced_knob_defaults = {"learning_rate": 3e-3, "weight_decay": 1e-4}

    @staticmethod
    def get_knob_config():
        return {
            "width_16ths": IntegerKnob(4, 16),
            "learning_rate": FloatKnob(3e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([64, 128, 256]),
            "weight_decay": FloatKnob(1e-5, 1e-3, is_exp=True),
            "max_epochs": IntegerKnob(3, 40),
            "early_stop_epochs": FixedKnob(5),
        }

    def create_module(self, n_classes: int, image_shape: Sequence[int]):
        return _Cnn(int(image_shape[-1]), n_classes, image_shape[:2],
                    seed=int(self.knobs.get("seed", 0)))

    def extra_apply_inputs(self) -> Dict[str, np.ndarray]:
        sixteenths = int(self.knobs.get("width_16ths", 16))
        return {"width_16ths":
                (np.arange(16) < sixteenths).astype(np.float32)}

    def module_config(self) -> Any:
        return ("_Cnn", int(self._meta.get("n_classes", 0)), MAX_WIDTH,
                N_STAGES, str(layers.COMPUTE))

    def stack_signature(self) -> Any:
        return (*super().stack_signature(), MAX_WIDTH, N_STAGES)

    def quantized_apply(self, qvars, scales, fvars, x, extra):
        """int8 serving (ref :108-153), the masked supernet's forward in
        f32: each convolution int8 × int8 -> int32
        (``dynamic_int8_conv``), each dense layer
        ``dynamic_int8_matmul``; a kernel left in f32 runs in f32."""
        mask16 = extra["width_16ths"]
        h = x
        n = 0
        for stage in range(N_STAGES):
            ch = MAX_WIDTH * 2 ** stage
            mask = mask16.repeat_interleave(ch // 16).to(torch.float32)
            for _ in range(2):
                k = f"params/Conv_{n}/kernel"
                b = fvars[f"params/Conv_{n}/bias"].float()
                if k in qvars:
                    h = dynamic_int8_conv(h, qvars[k], scales[k],
                                          padding=((1, 1), (1, 1))) + b
                else:
                    h = F.conv2d(h.permute(0, 3, 1, 2),
                                 fvars[k].float().permute(3, 2, 0, 1),
                                 padding=1).permute(0, 2, 3, 1) + b
                h = torch.clamp_min(h, 0.0) * mask
                n += 1
            if min(h.shape[1], h.shape[2]) >= 2:
                h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
        h = h.reshape(h.shape[0], -1)

        def dense_q(v, i):
            k = f"params/Dense_{i}/kernel"
            b = fvars[f"params/Dense_{i}/bias"].float()
            if k in qvars:
                return dynamic_int8_matmul(v, qvars[k], scales[k]) + b
            return v @ fvars[k].float() + b

        return dense_q(torch.clamp_min(dense_q(h, 0), 0.0), 1)
