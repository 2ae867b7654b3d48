"""Cancellation Context travelling with a request (a copy of the JAX
package's `runtime/engine.py` Context).

`stop_generating` is graceful (finish the current token); `kill` drops
everything now.  Contexts form a tree via `link_child` so cancelling an
upstream request propagates into nested downstream calls.
"""

from __future__ import annotations

import asyncio
import uuid


class Context:
    """Cancellation context for one in-flight request."""

    def __init__(self, request_id: str | None = None):
        self.id = request_id or uuid.uuid4().hex
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._children: list[Context] = []

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def is_killed(self) -> bool:
        return self._killed.is_set()

    def stop_generating(self) -> None:
        """Graceful: stop producing new tokens, let the stream finish."""
        self._stopped.set()
        for child in self._children:
            child.stop_generating()

    def kill(self) -> None:
        """Hard cancel: abandon the stream immediately."""
        self._killed.set()
        self._stopped.set()
        for child in self._children:
            child.kill()

    async def stopped(self) -> None:
        await self._stopped.wait()

    async def killed(self) -> None:
        await self._killed.wait()

    def link_child(self, child: "Context") -> "Context":
        """Propagate this context's cancellation into `child`."""
        self._children.append(child)
        if self.is_killed():
            child.kill()
        elif self.is_stopped():
            child.stop_generating()
        return child

    def child(self) -> "Context":
        return self.link_child(Context())
