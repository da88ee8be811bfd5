"""Exponential-backoff retry policy (JAX counterpart: ``fault/retry.py``).

The policy is explicit and read from the environment, as in the JAX
package; the reconnecting ``dist_async`` kvstore client that uses it there
is ROADMAP queue A item 7c-2:

``MXNET_KVSTORE_RETRIES``      attempts after the first failure (default 5)
``MXNET_KVSTORE_RETRY_DELAY``  base backoff seconds (default 0.05; doubles
                               per attempt, capped at ``max_delay``)

The helper is synchronous and without jitter: a deterministic backoff keeps
seeded chaos tests reproducible.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional, Tuple, Type

from ..base import MXNetError

__all__ = ["RetryPolicy", "call_with_retry", "RetryExhausted"]


class RetryExhausted(MXNetError):
    """All attempts failed; ``.last`` holds the final exception."""

    def __init__(self, msg: str, last: Optional[BaseException] = None):
        super().__init__(msg)
        self.last = last


class RetryPolicy:
    """``retries`` re-attempts with ``base_delay * 2**k`` backoff."""

    def __init__(self, retries: int = 5, base_delay: float = 0.05,
                 max_delay: float = 2.0,
                 retry_on: Tuple[Type[BaseException], ...] = (
                     ConnectionError, OSError, EOFError, TimeoutError)):
        self.retries = int(retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.retry_on = retry_on

    @classmethod
    def from_env(cls, **overrides) -> "RetryPolicy":
        kw = {"retries": int(os.environ.get("MXNET_KVSTORE_RETRIES", "5")),
              "base_delay": float(os.environ.get(
                  "MXNET_KVSTORE_RETRY_DELAY", "0.05"))}
        kw.update(overrides)
        return cls(**kw)

    def delay(self, attempt: int) -> float:
        return min(self.base_delay * (2 ** attempt), self.max_delay)

    def attempts(self) -> int:
        return self.retries + 1


def call_with_retry(fn: Callable, policy: Optional[RetryPolicy] = None,
                    describe: str = "",
                    on_retry: Optional[Callable[[int, BaseException],
                                                None]] = None):
    """Run ``fn()`` under ``policy``; ``on_retry(attempt, exc)`` runs before
    each backoff sleep (where a client reconnects). Raises
    :class:`RetryExhausted` carrying the final exception."""
    policy = policy or RetryPolicy.from_env()
    last: Optional[BaseException] = None
    for attempt in range(policy.attempts()):
        try:
            return fn()
        except policy.retry_on as e:
            last = e
            if attempt >= policy.retries:
                break
            if on_retry is not None:
                try:
                    on_retry(attempt, e)
                except policy.retry_on:
                    pass  # reconnect itself failed; backoff and loop
            time.sleep(policy.delay(attempt))
    raise RetryExhausted(
        f"{describe or 'operation'} failed after {policy.attempts()} "
        f"attempt(s): {type(last).__name__}: {last}", last=last)
