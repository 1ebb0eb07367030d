"""A broker module that (transitively) drags torch and triton in at
import time — the RTA602 TP: ``heavy`` and ``kernels`` are import-time
reachable from the bus root and import them eagerly."""

from ..heavy import helper


def serve():
    return helper()
