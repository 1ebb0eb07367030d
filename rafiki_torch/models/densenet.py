"""TorchDenseNet: the port of ``JaxDenseNet``.

The counterpart of ``rafiki_tpu/models/densenet.py``: DenseNet-BC with
the CIFAR stem (one 3×3 convolution to 2·growth channels, no max-pool),
``_DenseLayer`` (:32; BN-ReLU-1×1 to 4·growth, BN-ReLU-3×3 to growth,
concatenated on the channels), ``_Transition`` (:50; BN-ReLU-1×1 to
half the channels, a 2×2 average pool), a final BN-ReLU, the global
mean and a ``Dense`` head; the depth presets ``_BLOCK_CONFIGS`` (:94),
the knob space (:111-122), SGD with Nesterov momentum under the
warm-up cosine (:132) and pad-crop-flip augmentation on the device
(:140).

Layers compute as flax's do (``layers.py``): bf16 convolutions, f32
BatchNorm with flax's running update, an f32 head input cast to bf16.
Modules are named as flax names them (``Conv_0``, ``_DenseLayer_3``,
``_Transition_1/BatchNorm_0`` …), so the two packages' parameter files
interchange through ``bridge.dense_from_jax``. The network runs in
NCHW shapes over a channels-last view of the NHWC images.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..model import (CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob,
                     PolicyKnob)
from ..model.optim import scheduled_sgd, warmup_cosine_decay_schedule
from ..model.torch_model import TorchModel, pad_crop_flip
from . import layers
from .layers import BatchNorm, Conv, cast, dense, make_dense

#: Named depth presets (ref :94): DenseNet-121 is the reference's
#: architecture; the smaller ones keep trials and tests cheap.
BLOCK_CONFIGS = {
    "densenet_tiny": (2, 2, 2),
    "densenet_small": (4, 4, 4),
    "densenet_121": (6, 12, 24, 16),
}


class _DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int, gen: torch.Generator):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_0 = Conv(in_ch, 4 * growth, 1, gen)
        self.BatchNorm_1 = BatchNorm(4 * growth)
        self.Conv_1 = Conv(4 * growth, growth, 3, gen, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(torch.relu(self.BatchNorm_0(x)))
        h = self.Conv_1(torch.relu(self.BatchNorm_1(h)))
        return torch.cat([x, h.to(x.dtype)], dim=1)


class _Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, gen: torch.Generator):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_0 = Conv(in_ch, out_ch, 1, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.Conv_0(torch.relu(self.BatchNorm_0(x))),
                            2, 2)


class _DenseNet(nn.Module):
    def __init__(self, in_ch: int, block_config: Tuple[int, ...],
                 growth: int, n_classes: int, seed: int,
                 compression: float = 0.5):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        ch = 2 * growth
        self.Conv_0 = Conv(in_ch, ch, 3, gen, padding=1)
        self.layer_names = []
        n_layer, n_trans = 0, 0
        for i, n_layers in enumerate(block_config):
            for _ in range(n_layers):
                name = f"_DenseLayer_{n_layer}"
                self.add_module(name, _DenseLayer(ch, growth, gen))
                self.layer_names.append(name)
                n_layer += 1
                ch += growth
            if i != len(block_config) - 1:
                out = int(ch * compression)
                name = f"_Transition_{n_trans}"
                self.add_module(name, _Transition(ch, out, gen))
                self.layer_names.append(name)
                n_trans += 1
                ch = out
        self.BatchNorm_0 = BatchNorm(ch)
        self.Dense_0 = make_dense(ch, n_classes, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) f32 images -> (B, n_classes) bf16 logits."""
        x = self.Conv_0(cast(x.permute(0, 3, 1, 2)))
        for name in self.layer_names:
            x = getattr(self, name)(x)
        h = torch.relu(self.BatchNorm_0(x)).mean(dim=(2, 3))
        return dense(self.Dense_0, h)


class TorchDenseNet(TorchModel):
    """DenseNet-BC image classifier (BASELINE config 2)."""

    @staticmethod
    def get_knob_config():
        return {
            "arch": CategoricalKnob(
                ["densenet_tiny", "densenet_small", "densenet_121"]),
            "growth_rate": IntegerKnob(8, 32),
            "learning_rate": FloatKnob(1e-3, 3e-1, is_exp=True),
            "batch_size": CategoricalKnob([64, 128, 256]),
            "weight_decay": FloatKnob(1e-5, 1e-3, is_exp=True),
            "max_epochs": IntegerKnob(6, 60),
            "early_stop_epochs": FixedKnob(5),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
        }

    def create_module(self, n_classes: int, image_shape: Sequence[int]):
        return _DenseNet(
            in_ch=int(image_shape[-1]),
            block_config=BLOCK_CONFIGS[str(self.knobs.get(
                "arch", "densenet_121"))],
            growth=int(self.knobs.get("growth_rate", 32)),
            n_classes=n_classes, seed=int(self.knobs.get("seed", 0)))

    def create_optimizer(self, params, steps_per_epoch: int,
                         max_epochs: int):
        """``traced_hyperparam_optimizer(opt="sgdm", warmup=True,
        weight_decay=True)`` (ref ``jax_model.py:412-448``): the peak-1
        warm-up cosine (from 0.1, ``max(1, min(total // 20, 5 ·
        steps_per_epoch))`` warm-up steps, to 1e-3) times the
        ``learning_rate`` knob."""
        total = max(1, steps_per_epoch * max_epochs)
        wsteps = max(1, min(total // 20, 5 * steps_per_epoch))
        return scheduled_sgd(
            params, float(self.knobs.get("learning_rate", 0.1)),
            warmup_cosine_decay_schedule(0.1, 1.0, wsteps, total, 1e-3),
            total, weight_decay=float(self.knobs.get("weight_decay", 1e-4)))

    def augment_in_graph(self, x, step, row0=0):
        return pad_crop_flip(x, int(self.knobs.get("seed", 0)) + 1, step,
                             row0=row0)

    def module_config(self) -> Any:
        """What the reference's ``_DenseNet`` compares: blocks, growth,
        classes, compression, the CIFAR stem and the compute dtype."""
        return ("_DenseNet",
                BLOCK_CONFIGS[str(self.knobs.get("arch", "densenet_121"))],
                int(self.knobs.get("growth_rate", 32)),
                int(self._meta.get("n_classes", 0)), 0.5, "cifar",
                str(layers.COMPUTE))
