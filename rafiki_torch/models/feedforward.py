"""TorchFeedForward: the port of ``JaxFeedForward``.

The counterpart of ``rafiki_tpu/models/feedforward.py:38-108``: the same
knob config and the same masked supernet of ``MAX_LAYERS`` hidden layers
of ``MAX_UNITS`` units. A width mask multiplies each ReLU output, so
units beyond ``hidden_layer_units`` feed zeros forward; layer 0 always
runs, and a deeper layer passes its input through where the count mask
is 0. Eager PyTorch has no recompile for the masks to avoid, but they
stay: the parameters keep the supernet's shapes, so the two packages'
parameter files and warm starts interchange.

Each ``Dense`` runs as flax's ``Dense(dtype=bfloat16)`` does: a bf16
input, a bf16 cast of the f32 kernel, the product rounded to bf16, then
the bf16 bias added in bf16; the logits leave in bf16 and are cast to
f32 for the loss and the softmax. The parameters start from flax's
default initialisers (a truncated-normal LeCun kernel, a zero bias),
drawn from the ``seed`` knob with torch's generator.

Serving (ref :103-136): every trial shares the one supernet, so
members of any knobs stack (``stack_signature``), their masks stacked
with them; ``quantized_apply`` is the masked forward in f32 on
``dynamic_int8_matmul``, line for line the reference's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..model import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from ..model.torch_model import TorchModel, dynamic_int8_matmul
from .layers import dense, make_dense

MAX_LAYERS = 3
MAX_UNITS = 128


class _FeedForward(nn.Module):
    """The masked supernet. Layers are named as the flax module's
    (``Dense_0`` … ``Dense_{MAX_LAYERS}``)."""

    def __init__(self, in_features: int, n_classes: int, seed: int):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        widths = [in_features] + [MAX_UNITS] * MAX_LAYERS + [n_classes]
        for i in range(MAX_LAYERS + 1):
            setattr(self, f"Dense_{i}",
                    make_dense(widths[i], widths[i + 1], gen))

    def forward(self, x: torch.Tensor, hidden_layer_count: torch.Tensor,
                hidden_layer_units: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1).to(torch.bfloat16)
        units = hidden_layer_units.to(torch.bfloat16)
        for i in range(MAX_LAYERS):
            y = torch.relu(dense(getattr(self, f"Dense_{i}"), h)) * units
            h = y if i == 0 else torch.where(hidden_layer_count[i] > 0, y, h)
        return dense(getattr(self, f"Dense_{MAX_LAYERS}"), h)


class TorchFeedForward(TorchModel):

    @staticmethod
    def get_knob_config():
        return {
            "hidden_layer_count": IntegerKnob(1, MAX_LAYERS),
            "hidden_layer_units": IntegerKnob(16, MAX_UNITS),
            "learning_rate": FloatKnob(1e-4, 1e-2, is_exp=True),
            "batch_size": CategoricalKnob([32, 64, 128]),
            "max_epochs": FixedKnob(5),
        }

    def create_module(self, n_classes: int, image_shape: Sequence[int]):
        return _FeedForward(int(np.prod(image_shape)), n_classes,
                            seed=int(self.knobs.get("seed", 0)))

    def extra_apply_inputs(self) -> Dict[str, np.ndarray]:
        count = int(self.knobs.get("hidden_layer_count", MAX_LAYERS))
        units = int(self.knobs.get("hidden_layer_units", MAX_UNITS))
        return {
            "hidden_layer_count":
                (np.arange(MAX_LAYERS) < count).astype(np.float32),
            "hidden_layer_units":
                (np.arange(MAX_UNITS) < units).astype(np.float32),
        }

    def module_config(self) -> Any:
        return ("_FeedForward", MAX_LAYERS, MAX_UNITS,
                int(self._meta.get("n_classes", 0)), "bfloat16")

    def stack_signature(self) -> Any:
        # Every trial shares the fixed supernet, so members stack
        # whatever width and depth masks their knobs give.
        return (*super().stack_signature(), MAX_LAYERS, MAX_UNITS)

    def quantized_apply(self, qvars: Dict[str, torch.Tensor],
                        scales: Dict[str, torch.Tensor],
                        fvars: Dict[str, torch.Tensor], x: torch.Tensor,
                        extra: Dict[str, torch.Tensor]
                        ) -> Optional[torch.Tensor]:
        """int8 serving: every dense product int8 × int8 -> int32
        (``dynamic_int8_matmul``), the masked supernet's forward in f32;
        a kernel left in f32 runs a plain f32 product."""

        def dense_q(h, i):
            k = f"params/Dense_{i}/kernel"
            b = fvars[f"params/Dense_{i}/bias"].to(torch.float32)
            if k in qvars:
                return dynamic_int8_matmul(h, qvars[k], scales[k]) + b
            return h @ fvars[k].to(torch.float32) + b

        count_mask = extra["hidden_layer_count"]
        units_mask = extra["hidden_layer_units"]
        h = x.reshape(x.shape[0], -1)
        for i in range(MAX_LAYERS):
            y = torch.clamp_min(dense_q(h, i), 0.0)
            y = y * units_mask.to(y.dtype)
            h = y if i == 0 else torch.where(
                count_mask[i].to(y.dtype) > 0, y, h)
        return dense_q(h, MAX_LAYERS)
