"""OpenAIPreprocessor — OpenAI request → PreprocessedRequest.

The port's copy of the JAX package's `llm/preprocessor.py`: chat template
(jinja2), tokenization, sampling-option mapping and validation.
Multimodal content and embeddings raise `RequestError` (later slices).
Mirrors the reference preprocessor contract
(lib/llm/src/preprocessor.rs:102 `OpenAIPreprocessor`:
chat-template render → tokenize → sampling-option mapping) producing the
engine wire request:

    {"token_ids": [...], "sampling_options": {...}, "stop_conditions": {...},
     "annotations": {...}}

Tokenization is CPU work; callers run `preprocess` in an executor when on a
hot path (the reference offloads to a Rayon pool, compute/pool.rs).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import jinja2

from .model_card import ModelDeploymentCard
from .tokenizer import HuggingFaceTokenizer

# minimal fallback when the checkpoint ships no chat template
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|>\n{{ message['content'] }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


class RequestError(ValueError):
    """Maps to HTTP 400."""


class OpenAIPreprocessor:
    def __init__(self, mdc: ModelDeploymentCard, tokenizer: HuggingFaceTokenizer):
        self.mdc = mdc
        self.tokenizer = tokenizer
        template = (
            mdc.chat_template or tokenizer.chat_template or DEFAULT_CHAT_TEMPLATE
        )
        env = jinja2.Environment(autoescape=False, keep_trailing_newline=True)
        env.globals["raise_exception"] = _jinja_raise
        self._template = env.from_string(template)

    # -- chat ---------------------------------------------------------------- #

    def apply_template(self, messages: List[Dict[str, Any]],
                       tools: Optional[list] = None,
                       add_generation_prompt: bool = True,
                       image_token: str = "") -> str:
        for m in messages:
            if not isinstance(m, dict) or "role" not in m:
                raise RequestError("each message needs a 'role'")
        try:
            return self._template.render(
                messages=_normalize_messages(messages, image_token),
                tools=tools,
                add_generation_prompt=add_generation_prompt,
                bos_token="",
                eos_token="",
            )
        except jinja2.TemplateError as e:
            raise RequestError(f"chat template failed: {e}") from e

    def preprocess_chat(self, request: Dict[str, Any]) -> Dict[str, Any]:
        messages = request.get("messages")
        if not messages:
            raise RequestError("'messages' must be a non-empty list")
        if _has_media(messages):
            raise RequestError(
                f"model {self.mdc.name!r} does not accept image input"
            )
        prompt = self.apply_template(messages, tools=request.get("tools"))
        token_ids = self.tokenizer.encode(prompt)
        if self.tokenizer.bos_token_id is not None and (
            not token_ids or token_ids[0] != self.tokenizer.bos_token_id
        ):
            token_ids = [self.tokenizer.bos_token_id] + token_ids
        return self._finish(request, token_ids, prompt)

    # -- completions --------------------------------------------------------- #

    def preprocess_completion(self, request: Dict[str, Any]) -> Dict[str, Any]:
        prompt = request.get("prompt")
        if prompt is None:
            raise RequestError("'prompt' is required")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            token_ids = list(prompt)  # pre-tokenized input
            prompt = None
        elif isinstance(prompt, str):
            token_ids = self.tokenizer.encode(prompt)
        else:
            raise RequestError("'prompt' must be a string or token array")
        out = self._finish(request, token_ids, prompt)
        if out["stop_conditions"]["max_tokens"] is None:
            out["stop_conditions"]["max_tokens"] = 16  # legacy OpenAI default
        return out

    # -- embeddings ----------------------------------------------------------- #

    def preprocess_embedding(self, request: Dict[str, Any]) -> Dict[str, Any]:
        raise RequestError("embeddings are not ported to dynamo_tpu_torch yet")

    # -- shared -------------------------------------------------------------- #

    def _finish(self, request: Dict[str, Any], token_ids: List[int],
                prompt: Optional[str]) -> Dict[str, Any]:
        if len(token_ids) >= self.mdc.context_length:
            raise RequestError(
                f"prompt is {len(token_ids)} tokens; model context is "
                f"{self.mdc.context_length}"
            )
        max_tokens = request.get("max_completion_tokens") or request.get("max_tokens")
        stop = request.get("stop")
        if isinstance(stop, str):
            stop = [stop]
        stop = stop or []
        if len(stop) > 4:
            raise RequestError("at most 4 stop sequences")
        _validate_sampling(request)
        # chat: logprobs is a bool + top_logprobs int; legacy completions:
        # logprobs is an int k meaning "top-k per token"
        logprobs = request.get("logprobs")
        if isinstance(logprobs, bool) or logprobs is None:
            want_logprobs = bool(logprobs)
            top_logprobs = int(request.get("top_logprobs") or 0)
        else:
            want_logprobs = True
            top_logprobs = int(logprobs)
        nvext = request.get("nvext", {}) or {}
        # priority class: body field wins over nvext, model card default
        # fills the rest (docs/overload_control.md)
        priority = (request.get("priority") or nvext.get("priority")
                    or self.mdc.priority_class or "interactive")
        if priority not in ("interactive", "batch"):
            raise RequestError(
                "'priority' must be 'interactive' or 'batch'"
            )
        return {
            "token_ids": token_ids,
            "priority": priority,
            "sampling_options": {
                "temperature": request.get("temperature"),
                "top_p": request.get("top_p"),
                "top_k": request.get("top_k"),
                "seed": request.get("seed"),
                "frequency_penalty": request.get("frequency_penalty"),
                "presence_penalty": request.get("presence_penalty"),
                "logprobs": want_logprobs,
                "top_logprobs": top_logprobs,
                "n": int(request.get("n") or 1),
            },
            "stop_conditions": {
                "max_tokens": max_tokens,
                # text-level stops are matched by the frontend postprocessor
                # (may straddle token boundaries); EOS handling is engine-side
                # via its own eos_token_ids so ignore_eos works
                "stop_sequences_text": stop,
                "stop_token_ids": list(request.get("stop_token_ids") or []),
                "ignore_eos": bool(nvext.get("ignore_eos", False)),
            },
            "annotations": {"prompt": prompt} if nvext.get("annotations") else {},
        }


_RANGES = {
    "temperature": (0.0, 2.0),
    "top_p": (0.0, 1.0),
    "frequency_penalty": (-2.0, 2.0),
    "presence_penalty": (-2.0, 2.0),
}


def _validate_sampling(request: Dict[str, Any]) -> None:
    """Reject out-of-range sampling parameters with 400 instead of
    silently accepting them (reference behavior: parameters map into engine
    sampling options or fail validation, preprocessor.rs:102)."""
    for key, (lo, hi) in _RANGES.items():
        v = request.get(key)
        if v is None:
            continue
        if not isinstance(v, (int, float)) or not lo <= v <= hi:
            raise RequestError(f"'{key}' must be a number in [{lo}, {hi}]")
    n = request.get("n")
    if n is not None and (not isinstance(n, int) or not 1 <= n <= 16):
        raise RequestError("'n' must be an integer in [1, 16]")
    tl = request.get("top_logprobs")
    if tl is not None and (not isinstance(tl, int) or not 0 <= tl <= 20):
        raise RequestError("'top_logprobs' must be an integer in [0, 20]")
    lp = request.get("logprobs")
    if lp is not None and not isinstance(lp, bool):
        if not isinstance(lp, int) or not 0 <= lp <= 20:
            raise RequestError("'logprobs' must be a bool or an int in [0, 20]")


def _normalize_messages(messages: List[Dict[str, Any]],
                        image_token: str = "") -> List[Dict[str, Any]]:
    """Flatten OpenAI content-part arrays to plain strings; image parts
    become the model's single placeholder token (expanded to the patch
    run after tokenization — reference encode_worker_handler.py:144)."""
    out = []
    for m in messages:
        content = m.get("content")
        if isinstance(content, list):
            texts = []
            for part in content:
                if isinstance(part, dict) and part.get("type") == "text":
                    texts.append(part.get("text", ""))
                elif (isinstance(part, dict)
                        and part.get("type") in ("image_url", "video_url")
                        and image_token):
                    # video parts share the image placeholder: media
                    # order matches placeholder order, and per-media
                    # token counts disambiguate at expansion time
                    texts.append(image_token)
                else:
                    raise RequestError(
                        "unsupported content part for this model"
                    )
            content = "".join(texts)
        out.append({**m, "content": content or ""})
    return out


def _has_media(messages: List[Dict[str, Any]]) -> bool:
    """Any image or video content part (multimodal input is a later
    slice of the port)."""
    return any(
        isinstance(part, dict) and part.get("type") in ("image_url", "video_url")
        for m in messages if isinstance(m, dict)
        for part in (m.get("content") if isinstance(m.get("content"), list) else [])
    )


def _jinja_raise(msg):
    raise jinja2.TemplateError(msg)
