"""Ops of the port: attention and its Hopper kernels, sequence-parallel
attention, the Switch MoE FFN and the GPipe pipeline."""

from .attention import (NEG_INF, blockwise_attention, default_attention,
                        flash_attention, flash_attention_dkv,
                        flash_attention_dkv_reference, flash_attention_dq,
                        flash_attention_dq_reference, flash_attention_plain,
                        flash_attention_reference, naive_attention,
                        ring_attention, sequence_sharded_attention,
                        ulysses_attention)
from .moe import switch_moe
from .pipeline import pipeline_apply, pipelined

__all__ = ["NEG_INF", "blockwise_attention", "default_attention",
           "flash_attention", "flash_attention_dkv",
           "flash_attention_dkv_reference", "flash_attention_dq",
           "flash_attention_dq_reference", "flash_attention_plain",
           "flash_attention_reference", "naive_attention", "pipeline_apply",
           "pipelined", "ring_attention", "sequence_sharded_attention",
           "switch_moe", "ulysses_attention"]
