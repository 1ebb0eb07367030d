"""TorchEnas: the port of ``JaxEnas``.

The counterpart of ``rafiki_tpu/models/enas.py``: a cell network whose
architecture ``EnasAdvisor`` searches. ``N_OPS`` (:46) candidate ops
per block slot (identity, separable 3×3 and 5×5 convolutions, 3×3
average and max pools), ``_gn_groups`` (:49), ``_SepConv`` (:56;
ReLU, depthwise k×k, pointwise 1×1, GroupNorm), ``_Calibrate`` (:75;
ReLU, strided 1×1, GroupNorm), the network (:93-196) and the model
with its class-level sizes (:198-267).

The architecture has shape (2, n_blocks, 4): cell type (normal,
reduction) × block × (input 1, op 1, input 2, op 2). Input indices
address ``[s0, s1, block_0, …]``; op indices the candidate ops.

- **Masked supernet** (``share_params`` on): the architecture enters
  every forward as a device tensor through ``extra_apply_inputs``. Each
  slot computes every candidate op and takes the chosen one by index
  from their stack, as the reference's one-hot ``einsum`` takes it (the
  same values and gradients: the other terms are exact zeros); the
  inputs are chosen the same way from the stack of states. The
  parameters do not depend on the architecture, so one captured train
  step serves every architecture and ``GLOBAL_RECENT`` warm starts
  overlay every tensor.
- **Single path** (``fixed_arch``): only the chosen branches are built,
  under the same names, so its parameters are a subset of the
  supernet's.

Reduction cells sit at ``n_cells // 3`` and ``2·n_cells // 3``; a
cell's ``s0`` is calibrated with stride ``s0 size // s1p size``, sizes
known from the image shape when the module is built. Layers compute as
flax's (``layers.py``): bf16 convolutions, f32 GroupNorm (eps 1e-6)
cast back to bf16. The network runs in NCHW shapes over a
channels-last view of the NHWC images.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..model import ArchKnob, FixedKnob, PolicyKnob
from ..model.optim import cosine_decay_schedule, scheduled_sgd
from ..model.torch_model import TorchModel, pad_crop_flip
from . import layers
from .layers import (Conv, GroupNorm, avg_pool3, cast, dense, make_dense,
                     max_pool3, stacked)

N_OPS = 5  # identity, sep-conv 3x3, sep-conv 5x5, avg-pool 3x3, max-pool 3x3


def _pick(xs, i: torch.Tensor) -> torch.Tensor:
    """``xs[i]`` for a device index ``i``: a copy of the chosen tensor,
    kept channels-last as the tensors it comes from (contiguous under
    the members' ``vmap``, which knows no other layout)."""
    x = torch.stack(xs).index_select(0, i.view(1))[0]
    if stacked(x):
        return x.contiguous()
    return x.contiguous(memory_format=torch.channels_last)


def _gn_groups(c: int) -> int:
    g = 8
    while g > 1 and c % g:
        g //= 2
    return g


class _SepConv(nn.Module):
    """ReLU -> depthwise k×k -> pointwise 1×1 -> GroupNorm."""

    def __init__(self, c: int, kernel: int, gen: torch.Generator):
        super().__init__()
        self.Conv_0 = Conv(c, c, kernel, gen, padding=kernel // 2, groups=c)
        self.Conv_1 = Conv(c, c, 1, gen)
        self.GroupNorm_0 = GroupNorm(_gn_groups(c), c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_1(self.Conv_0(torch.relu(x)))
        return cast(self.GroupNorm_0(x))


class _Calibrate(nn.Module):
    """ReLU -> strided 1×1 conv -> GroupNorm."""

    def __init__(self, in_ch: int, c: int, stride: int,
                 gen: torch.Generator):
        super().__init__()
        self.Conv_0 = Conv(in_ch, c, 1, gen, stride=stride)
        self.GroupNorm_0 = GroupNorm(_gn_groups(c), c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cast(self.GroupNorm_0(self.Conv_0(torch.relu(x))))


class _EnasNet(nn.Module):
    """Cell network; a masked supernet when ``fixed_arch`` is None."""

    def __init__(self, in_ch: int, image_size: int, n_blocks: int,
                 n_cells: int, channels: int, n_classes: int, seed: int,
                 fixed_arch: Optional[Tuple[int, ...]] = None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.n_blocks, self.n_cells = n_blocks, n_cells
        self.fixed = (None if fixed_arch is None else
                      np.asarray(fixed_arch, np.int64).reshape(
                          2, n_blocks, 4).tolist())
        c = channels
        self.stem_conv = Conv(in_ch, c, 3, gen, padding=1)
        self.stem_gn = GroupNorm(_gn_groups(c), c)
        self.reduce_at = ({n_cells // 3, (2 * n_cells) // 3}
                          if n_cells >= 3 else set())
        ch0 = ch1 = c
        size0 = size1 = image_size
        for ci in range(n_cells):
            reduction = ci in self.reduce_at
            stride = 2 if reduction else 1
            if reduction:
                c *= 2
            size1p = -(-size1 // stride)
            s0_stride = max(1, size0 // size1p)
            self.add_module(f"c{ci}_pre1", _Calibrate(ch1, c, stride, gen))
            self.add_module(f"c{ci}_pre0",
                            _Calibrate(ch0, c, s0_stride, gen))
            for b in range(n_blocks):
                for slot in range(2):
                    name = f"c{ci}_b{b}_s{slot}"
                    ops = (range(N_OPS) if self.fixed is None else
                           [self.fixed[1 if reduction else 0][b][2 * slot
                                                                 + 1]])
                    for op, k in ((1, 3), (2, 5)):
                        if op in ops:
                            self.add_module(f"{name}_sep{k}",
                                            _SepConv(c, k, gen))
            self.add_module(f"c{ci}_out", Conv(n_blocks * c, c, 1, gen))
            self.add_module(f"c{ci}_out_gn", GroupNorm(_gn_groups(c), c))
            ch0, ch1 = ch1, c
            size0, size1 = size1, size1p
        self.head = make_dense(c, n_classes, gen)

    def _op(self, name: str, op, x: torch.Tensor,
            masked: bool) -> torch.Tensor:
        def branch(i: int) -> torch.Tensor:
            if i == 0:
                return x
            if i == 1:
                return getattr(self, f"{name}_sep3")(x)
            if i == 2:
                return getattr(self, f"{name}_sep5")(x)
            if i == 3:
                return avg_pool3(x)
            return max_pool3(x)

        if not masked:
            return branch(op)
        return _pick([branch(i) for i in range(N_OPS)], op)

    def _cell(self, ci: int, s0, s1, spec, masked: bool) -> torch.Tensor:
        states = [getattr(self, f"c{ci}_pre0")(s0),
                  getattr(self, f"c{ci}_pre1")(s1)]
        for b in range(self.n_blocks):
            in1, op1, in2, op2 = (spec[b][0], spec[b][1], spec[b][2],
                                  spec[b][3])
            if masked:
                x1, x2 = _pick(states, in1), _pick(states, in2)
            else:
                x1, x2 = states[in1], states[in2]
            name = f"c{ci}_b{b}"
            states.append(self._op(f"{name}_s0", op1, x1, masked)
                          + self._op(f"{name}_s1", op2, x2, masked))
        out = getattr(self, f"c{ci}_out")(torch.cat(states[2:], dim=1))
        return cast(getattr(self, f"c{ci}_out_gn")(out))

    def forward(self, x: torch.Tensor,
                arch: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, C) f32 images -> (B, n_classes) bf16 logits;
        ``arch`` (2, n_blocks, 4), on the device, for the supernet."""
        masked = self.fixed is None
        if masked:
            if arch is None:
                raise ValueError("the supernet needs the arch input")
            spec_of = arch.long()
        else:
            spec_of = self.fixed
        x = self.stem_conv(cast(x.permute(0, 3, 1, 2)))
        x = cast(self.stem_gn(x))
        s0 = s1 = x
        for ci in range(self.n_cells):
            spec = spec_of[1 if ci in self.reduce_at else 0]
            s0, s1 = s1, self._cell(ci, s0, s1, spec, masked)
        return dense(self.head, torch.relu(s1).mean(dim=(2, 3)))


class TorchEnas(TorchModel):
    """ENAS cell search over CIFAR-scale image classification.

    Drive with ``rafiki_torch.advisor.EnasAdvisor``: search trials get
    the SHARE_PARAMS, QUICK_TRAIN and DOWNSCALE policies (the masked
    supernet on shared weights, at the search sizes, one epoch); final
    trials train the controller's best architecture from scratch at the
    full sizes on the single-path network.
    """

    # Class-level sizes, so that a test can subclass a tiny variant; the
    # arch knob's positions derive from n_blocks.
    n_blocks = 4
    full_cells, full_channels = 6, 32
    search_cells, search_channels = 3, 16

    @classmethod
    def get_knob_config(cls):
        positions = []
        for _ct in range(2):
            for b in range(cls.n_blocks):
                positions += [list(range(b + 2)), list(range(N_OPS)),
                              list(range(b + 2)), list(range(N_OPS))]
        return {
            "arch": ArchKnob(positions),
            "batch_size": FixedKnob(128),
            "learning_rate": FixedKnob(0.05),
            "max_epochs": FixedKnob(10),
            "trial_epochs": FixedKnob(1),
            "share_params": PolicyKnob("SHARE_PARAMS"),
            "quick_train": PolicyKnob("QUICK_TRAIN"),
            "downscale": PolicyKnob("DOWNSCALE"),
        }

    def _searching(self) -> bool:
        return bool(self.knobs.get("share_params", False))

    def create_module(self, n_classes: int, image_shape: Sequence[int]):
        cls = type(self)
        down = bool(self.knobs.get("downscale", False))
        return _EnasNet(
            in_ch=int(image_shape[-1]), image_size=int(image_shape[0]),
            n_blocks=cls.n_blocks,
            n_cells=cls.search_cells if down else cls.full_cells,
            channels=cls.search_channels if down else cls.full_channels,
            n_classes=n_classes, seed=int(self.knobs.get("seed", 0)),
            fixed_arch=(None if self._searching()
                        else tuple(int(v) for v in self.knobs["arch"])))

    def extra_apply_inputs(self) -> Dict[str, np.ndarray]:
        if not self._searching():
            return {}
        arch = np.asarray([int(v) for v in self.knobs["arch"]], np.int32)
        return {"arch": arch.reshape(2, type(self).n_blocks, 4)}

    def create_optimizer(self, params, steps_per_epoch: int,
                         max_epochs: int):
        """The child-model recipe (ref :254-264): weight decay 1e-4 and
        Nesterov SGD (momentum 0.9) under a cosine decay of the
        ``learning_rate`` knob to ``alpha`` 1e-3 over the run."""
        total = max(1, steps_per_epoch * max_epochs)
        return scheduled_sgd(
            params, float(self.knobs.get("learning_rate", 0.05)),
            cosine_decay_schedule(1.0, total, alpha=1e-3), total,
            weight_decay=1e-4)

    def augment_in_graph(self, x, step, row0=0):
        return pad_crop_flip(x, int(self.knobs.get("seed", 0)) + 1, step,
                             row0=row0)

    def module_config(self) -> Any:
        """What the reference's ``_EnasNet`` compares: blocks, cells,
        channels, classes, the single path's architecture (None for the
        supernet, whose architecture is an input) and the compute
        dtype."""
        cls = type(self)
        down = bool(self.knobs.get("downscale", False))
        return ("_EnasNet", cls.n_blocks,
                cls.search_cells if down else cls.full_cells,
                cls.search_channels if down else cls.full_channels,
                int(self._meta.get("n_classes", 0)),
                None if self._searching()
                else tuple(int(v) for v in self.knobs["arch"]),
                str(layers.COMPUTE))
