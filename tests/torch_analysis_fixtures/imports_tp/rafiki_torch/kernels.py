"""Eager triton import, reachable through heavy.py — RTA602."""

import triton.language as tl

BLOCK = tl.constexpr(128)
