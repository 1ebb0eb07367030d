"""RTA602 FP guard: a TYPE_CHECKING torch import (never executes) and a
LAZY function-scoped import of the torch-heavy module — the sanctioned
observe/__init__ pattern."""

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch  # noqa: F401


def serve():
    from .. import heavy

    return heavy.helper()
