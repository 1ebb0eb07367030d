"""Placement of the platform's services on the node's cards."""

from .chips import ChipAllocator, ChipGroup

__all__ = ["ChipAllocator", "ChipGroup"]
