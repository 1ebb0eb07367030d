"""Eagerly imports torch and triton, but NOT import-time reachable from
the bus package (only the lazy function in broker.py touches it) — no
RTA602."""

import torch
import triton


def helper():
    return torch.cuda.device_count(), triton.__version__
