"""Ops of the port: attention and its Hopper kernel."""

from .attention import (NEG_INF, flash_attention, flash_attention_reference,
                        naive_attention)

__all__ = ["NEG_INF", "flash_attention", "flash_attention_reference",
           "naive_attention"]
