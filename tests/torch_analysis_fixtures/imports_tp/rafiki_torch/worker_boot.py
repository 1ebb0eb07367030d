"""RTA601 TPs: a thread built+started, a socket bound, a process
spawned, an env var read — all at import time — plus a class-body env
read (class bodies execute on import: the NODE_LEASE bug shape)."""

import os
import socket
import subprocess
import threading

HEARTBEAT = threading.Thread(target=print)
HEARTBEAT.start()

_SOCK = socket.socket()
_SOCK.bind(("127.0.0.1", 0))

TOOLCHAIN = subprocess.run(["true"], capture_output=True)

DEBUG = os.environ.get("APP_DEBUG", "0")

SUB_LEASE = float(os.environ["APP_SUB_LEASE"])


class Registry:
    LEASE = float(os.environ.get("APP_LEASE", "5"))


# Guard-polarity regressions (review fix): the else-arm of a __main__
# guard and the body of an INVERTED guard both execute on import.
if __name__ == "__main__":
    pass
else:
    ELSE_ARM = os.environ.get("APP_ELSE")

if __name__ != "__main__":
    INVERTED = os.environ.get("APP_INVERTED")
