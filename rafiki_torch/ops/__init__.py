"""Ops of the port: attention and its Hopper kernels."""

from .attention import (NEG_INF, blockwise_attention, default_attention,
                        flash_attention, flash_attention_dkv,
                        flash_attention_dkv_reference, flash_attention_dq,
                        flash_attention_dq_reference, flash_attention_plain,
                        flash_attention_reference, naive_attention)

__all__ = ["NEG_INF", "blockwise_attention", "default_attention",
           "flash_attention", "flash_attention_dkv",
           "flash_attention_dkv_reference", "flash_attention_dq",
           "flash_attention_dq_reference", "flash_attention_plain",
           "flash_attention_reference", "naive_attention"]
