"""Backend post-processor: engine token deltas → text deltas.

The port's copy of the JAX package's `llm/backend.py`.  The analog of the reference's `Backend` stage (backend.rs:55): incremental
detokenization plus *text-level* stop-sequence handling — a stop string can
straddle token boundaries, so emitted text is held back while it could
still be the start of a stop sequence, and trimmed when one matches.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

from .tokenizer import HuggingFaceTokenizer, IncrementalDetokenizer


class StreamPostprocessor:
    def __init__(
        self,
        tokenizer: HuggingFaceTokenizer,
        prompt_ids: Optional[Sequence[int]] = None,
        stop_sequences: Optional[List[str]] = None,
    ):
        self._detok = IncrementalDetokenizer(tokenizer, prompt_ids)
        self._stops = [s for s in (stop_sequences or []) if s]
        self._held = ""  # text withheld because it may prefix a stop seq
        self.finished_by_stop: Optional[str] = None

    def push_tokens(self, token_ids: Sequence[int]) -> str:
        """Feed engine tokens; returns releasable text delta."""
        if self.finished_by_stop is not None:
            return ""
        delta = "".join(self._detok.push(t) for t in token_ids)
        if not self._stops:
            return delta
        self._held += delta
        # full stop match → trim and finish
        for stop in self._stops:
            idx = self._held.find(stop)
            if idx != -1:
                out, self._held = self._held[:idx], ""
                self.finished_by_stop = stop
                return out
        # hold back the longest suffix that could still grow into a stop
        hold = 0
        for stop in self._stops:
            for k in range(min(len(stop) - 1, len(self._held)), 0, -1):
                if self._held.endswith(stop[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            out, self._held = self._held[:-hold], self._held[-hold:]
            return out
        out, self._held = self._held, ""
        return out

    def flush(self) -> str:
        """End of stream: release anything still held."""
        if self.finished_by_stop is not None:
            return ""
        out, self._held = self._held, ""
        return out


async def postprocess_stream(
    engine_stream: AsyncIterator[Dict[str, Any]],
    tokenizer: HuggingFaceTokenizer,
    prompt_ids: Optional[Sequence[int]] = None,
    stop_sequences: Optional[List[str]] = None,
) -> AsyncIterator[Dict[str, Any]]:
    """Wrap an engine token stream into {'text': delta, 'finish_reason': ...,
    'token_ids': [...]} items."""
    post = StreamPostprocessor(tokenizer, prompt_ids, stop_sequences)
    async for out in engine_stream:
        if out.get("finish_reason") == "error":
            yield {"text": "", "finish_reason": "error",
                   "error": out.get("error", "engine error"), "token_ids": []}
            return
        text = post.push_tokens(out.get("token_ids", []))
        reason = out.get("finish_reason")
        passthrough = {
            k: out[k]
            for k in ("log_probs", "top_logprobs", "spec", "ttft")
            if k in out
        }
        if post.finished_by_stop is not None:
            yield {"text": text, "finish_reason": "stop",
                   "token_ids": out.get("token_ids", []), **passthrough}
            return
        if reason:
            text += post.flush()
            yield {"text": text, "finish_reason": reason,
                   "token_ids": out.get("token_ids", []), **passthrough}
            return
        if text or out.get("token_ids"):
            yield {"text": text, "finish_reason": None,
                   "token_ids": out.get("token_ids", []), **passthrough}
    # engine stream ended without a finish reason (cancelled upstream)
    tail = post.flush()
    if tail:
        yield {"text": tail, "finish_reason": None, "token_ids": []}
