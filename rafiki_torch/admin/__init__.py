"""The platform's control plane: the admin, its REST service and the
services manager that places jobs' services on the node's cards."""

from .admin import Admin
from .services_manager import ServicesManager, normalize_budget

__all__ = ["Admin", "ServicesManager", "normalize_budget"]
