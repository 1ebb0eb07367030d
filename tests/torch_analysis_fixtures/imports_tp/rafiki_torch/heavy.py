"""Eager torch import, reachable from rafiki_torch/bus/ — RTA602."""

import torch

from . import kernels


def helper():
    return torch.cuda.device_count(), kernels.BLOCK
