"""RTA601 FP guard: the same effects placed correctly — env and
threads resolved inside functions, the module-level thread under the
``__main__`` guard (it never runs on a bare import)."""

import os
import threading


def serve():
    t = threading.Thread(target=print, daemon=True)
    t.start()
    return os.environ.get("APP_DEBUG")


class Registry:
    def __init__(self):
        self.lease = float(os.environ.get("APP_LEASE", "5"))


if __name__ == "__main__":
    MAIN = threading.Thread(target=serve)
    MAIN.start()
