"""The SDK app developers and model developers drive the platform
with."""

from .client import Client, ClientError

__all__ = ["Client", "ClientError"]
