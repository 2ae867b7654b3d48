"""Request migration — seamless retry on worker death.

The port's copy of the JAX package's `llm/migration.py`, the reference's
Migration stage (lib/llm/src/migration.rs,
docs/architecture/request_migration.md): the frontend accumulates generated
tokens into the request; when the worker stream dies mid-generation, the
request is re-issued to another worker with `prompt + generated` as the new
prompt and the generation budget reduced — the client sees an uninterrupted
token stream.  Works because engines treat any token prefix as a prompt
(and the prefix cache usually makes the re-prefill cheap).

Retries are paced: a failure with no progress since the last attempt waits
a capped exponential backoff with jitter before re-issuing (a deterministic
rejection — every worker refusing — would otherwise burn the whole
migration budget in microseconds); a failure *after* progress is a fresh
incident and retries immediately.  Both knobs ride the
ModelDeploymentCard (`migration_backoff_ms`, `migration_backoff_max_ms`).
The JAX version also opens a ``migration.reissue`` tracing span at each
re-issue and marks the re-issued stream's first delta with a migration
incident for the frontend's per-request waterfall; the port has neither
a tracing layer nor a waterfall yet, so it logs the re-issue only.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any, AsyncIterator, Callable, Dict, Optional

from ..runtime import Context
from ..runtime.transport.service import (
    Overloaded,
    RemoteStreamError,
    ServiceUnavailable,
)

logger = logging.getLogger(__name__)

# engine stream factory: (request, context) -> async iterator
StreamFactory = Callable[[Dict[str, Any], Context], AsyncIterator[Dict[str, Any]]]

# migration telemetry events handed to `on_migration`
MIGRATED = "migrated"      # stream re-issued to another worker
EXHAUSTED = "exhausted"    # migration limit hit; error surfaced to client


def _backoff_s(attempt: int, base_ms: int, max_ms: int,
               rng: Optional[random.Random] = None) -> float:
    """Capped exponential backoff with jitter in [0.5, 1.0) of the step."""
    if base_ms <= 0:
        return 0.0
    step = min(base_ms * (2 ** max(attempt - 1, 0)), max(max_ms, base_ms))
    r = rng.random() if rng is not None else random.random()
    return step * (0.5 + r / 2) / 1e3


async def migrating_stream(
    request: Dict[str, Any],
    context: Context,
    stream_factory: StreamFactory,
    migration_limit: int = 3,
    backoff_ms: int = 0,
    backoff_max_ms: int = 2000,
    on_migration: Optional[Callable[[str], None]] = None,
    _rng: Optional[random.Random] = None,
) -> AsyncIterator[Dict[str, Any]]:
    """Stream engine outputs, transparently migrating on transport failure."""
    prompt = list(request.get("token_ids") or [])
    generated: list[int] = []
    budget = (request.get("stop_conditions") or {}).get("max_tokens")
    attempts = 0
    while True:
        attempt_request = request
        if generated:
            if isinstance(budget, int) and budget - len(generated) <= 0:
                # the worker died after delivering the full budget but
                # before the finish chunk — the stream is complete
                yield {"token_ids": [], "finish_reason": "length"}
                return
            sc = dict(request.get("stop_conditions") or {})
            if isinstance(budget, int):
                sc["max_tokens"] = budget - len(generated)
            attempt_request = {
                **request,
                "token_ids": prompt + generated,
                "stop_conditions": sc,
            }
        progressed = False
        try:
            async for out in stream_factory(attempt_request, context):
                toks = out.get("token_ids") or []
                generated.extend(toks)
                progressed = progressed or bool(toks)
                yield out
                if out.get("finish_reason"):
                    return
            # stream ended without finish_reason: treat as worker loss
            raise RemoteStreamError("stream ended without finish")
        except (ServiceUnavailable, RemoteStreamError, ConnectionError) as e:
            if isinstance(e, Overloaded) and not generated:
                # deliberate load shedding before any output: retrying
                # cannot help — surface the 503 immediately
                raise
            if context.is_killed() or context.is_stopped():
                return
            if progressed:
                # progress means this failure is a fresh incident, not a
                # deterministic rejection looping — reset the budget
                attempts = 0
            attempts += 1
            if attempts > migration_limit:
                logger.error(
                    "request %s: migration limit (%d) exhausted: %s",
                    context.id, migration_limit, e,
                )
                if on_migration is not None:
                    on_migration(EXHAUSTED)
                yield {"token_ids": [], "finish_reason": "error",
                       "error": f"migration exhausted after {attempts - 1} "
                                f"retries; last error: {e}"}
                return
            logger.info(
                "request %s: migrating after %d tokens (attempt %d): %s",
                context.id, len(generated), attempts, e,
            )
            if on_migration is not None:
                on_migration(MIGRATED)
            if not progressed:
                # no progress since the last attempt: pace the retry so a
                # cluster-wide incident isn't hammered by every stream
                delay = _backoff_s(attempts, backoff_ms, backoff_max_ms, _rng)
                if delay > 0:
                    await asyncio.sleep(delay)
                    if context.is_killed() or context.is_stopped():
                        return
