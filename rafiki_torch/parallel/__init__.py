"""Placement of the platform's services on the node's cards, and the
mesh a trial's devices form."""

from .chips import ChipAllocator, ChipGroup, discover_topology
from .mesh import (DP_AXIS, EP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS, Mesh, Placed,
                   Sharding, batch_sharding, build_mesh, param_spec,
                   replicated, shard_variables, variables_shardings)
from .transfer import HostStager, device_get_tree, make_host_stager

__all__ = ["ChipAllocator", "ChipGroup", "DP_AXIS", "EP_AXIS", "HostStager",
           "Mesh", "PP_AXIS", "Placed", "SP_AXIS", "Sharding", "TP_AXIS",
           "batch_sharding", "build_mesh", "device_get_tree",
           "discover_topology", "make_host_stager", "param_spec",
           "replicated", "shard_variables", "variables_shardings"]
