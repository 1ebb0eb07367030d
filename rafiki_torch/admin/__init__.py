"""The platform's control plane: the admin, its REST service and the
services manager that places jobs' services on the node's cards.

``Admin`` and ``ServicesManager`` load on first use, so a tool that needs
only a light module here (``python -m rafiki_torch.capacity``) does not
import torch."""

__all__ = ["Admin", "ServicesManager", "normalize_budget"]


def __getattr__(name):
    if name == "Admin":
        from .admin import Admin

        return Admin
    if name in ("ServicesManager", "normalize_budget"):
        from . import services_manager

        return getattr(services_manager, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
