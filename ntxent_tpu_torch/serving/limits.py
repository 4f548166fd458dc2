"""Request-size limits of the serving path.

A body has to be parsed before it can be queued, so the bounded queue
alone does not protect memory: bodies over this cap get 413 and
``Connection: close`` without being read.
"""

MAX_BODY_BYTES = 32 << 20

__all__ = ["MAX_BODY_BYTES"]
