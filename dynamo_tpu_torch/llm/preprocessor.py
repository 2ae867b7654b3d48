"""OpenAIPreprocessor — OpenAI request → PreprocessedRequest.

The port's copy of the JAX package's `llm/preprocessor.py`: chat template
(jinja2), tokenization, sampling-option mapping and validation, and
multimodal content: image and video parts become the model's placeholder
runs and the request carries the processed media (`_process_images` for
CLIP towers, `_process_media_qwen` for dynamic-resolution Qwen towers).
Embeddings (`preprocess_embedding`) become ``{"embed_token_ids": ...}``.
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
        from .multimodal import extract_media

        media = extract_media(messages)
        if media and not self.mdc.image_token:
            raise RequestError(
                f"model {self.mdc.name!r} does not accept image input"
            )
        if any(m["kind"] == "video" for m in media) and (
            self.mdc.mm_arch != "qwen2_vl"
        ):
            raise RequestError(
                f"model {self.mdc.name!r} does not accept video input"
            )
        prompt = self.apply_template(messages, tools=request.get("tools"),
                                     image_token=self.mdc.image_token)
        token_ids = self.tokenizer.encode(prompt)
        if self.tokenizer.bos_token_id is not None and (
            not token_ids or token_ids[0] != self.tokenizer.bos_token_id
        ):
            token_ids = [self.tokenizer.bos_token_id] + token_ids
        mm = None
        if media:
            if self.mdc.mm_arch == "qwen2_vl":
                token_ids, mm = self._process_media_qwen(token_ids, media)
            else:
                token_ids, mm = self._process_images(
                    token_ids, [m["url"] for m in media])
        out = self._finish(request, token_ids, prompt)
        if mm:
            out.update(mm)
        return out

    def _media_token_id(self) -> int:
        tok_id = self.mdc.image_token_id
        if tok_id is None:
            ids = self.tokenizer.encode(self.mdc.image_token)
            if len(ids) != 1:
                raise RequestError(
                    "model's image_token does not map to a single token")
            tok_id = ids[0]
        return tok_id

    def _process_images(self, token_ids, image_urls):
        """CLIP towers: load and resize each image to the tower's square
        input, expand each placeholder to the image's patch run (the tower
        runs on the worker)."""
        import hashlib

        import numpy as np

        from .multimodal import (expand_image_tokens, load_image_bytes,
                                 pack_pixels, process_image)

        token_ids, offsets = expand_image_tokens(
            token_ids, self._media_token_id(), len(image_urls),
            self.mdc.image_patches)
        pixels = np.stack([process_image(load_image_bytes(u), self.mdc.image_size)
                           for u in image_urls])
        return token_ids, {
            "mm_pixels": pack_pixels(pixels),
            "mm_offsets": offsets,
            # per-image cache namespace: MUST equal the engine's
            # seq.cache_salt (identical tokens, another image: no reuse)
            "cache_salt": hashlib.blake2b(
                np.ascontiguousarray(pixels, np.float32).tobytes(),
                digest_size=8).hexdigest(),
        }

    def _process_media_qwen(self, token_ids, media):
        """Qwen2-VL media: smart-resize each image or video to its own grid,
        patchify on the host and expand each placeholder to that medium's
        merged token count; ships per-medium patch blobs and grids."""
        import hashlib

        import numpy as np

        from ..models.qwen_vl import (Qwen2VLVisionConfig, frames_to_patches,
                                      merged_tokens, smart_resize)
        from .multimodal import (MAX_VIDEO_FRAMES, expand_media_tokens,
                                 image_size, load_image_bytes, pack_patches,
                                 process_frames)

        vcfg = Qwen2VLVisionConfig.from_hf_config(self.mdc.mm_config or {})
        tok_id = self._media_token_id()
        blobs, counts = [], []
        salts = hashlib.blake2b(digest_size=8)
        for m in media:
            raw = load_image_bytes(m["url"])
            w0, h0 = image_size(raw)
            try:
                h1, w1 = smart_resize(h0, w0, vcfg)
            except ValueError as e:
                raise RequestError(f"cannot resize media: {e}") from None
            frames = process_frames(
                raw, h1, w1,
                max_frames=1 if m["kind"] == "image" else MAX_VIDEO_FRAMES)
            patches, grid = frames_to_patches(frames, vcfg)
            blobs.append(pack_patches(patches, grid))
            counts.append(merged_tokens(grid, vcfg))
            salts.update(np.ascontiguousarray(patches).tobytes())
        token_ids, offsets = expand_media_tokens(token_ids, tok_id, counts)
        return token_ids, {
            "mm_patches": blobs,
            "mm_offsets": offsets,
            # content salt, as the CLIP path (must equal the engine's)
            "cache_salt": salts.hexdigest(),
        }

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
        """OpenAI embeddings request -> engine embed request (the analog of
        the reference's preprocessor.rs `preprocess_embedding_request`)."""
        inputs = request.get("input")
        if inputs is None:
            raise RequestError("'input' is required")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list) or not inputs:
            raise RequestError("'input' must be a non-empty string or list")
        if isinstance(inputs[0], int):  # single token array
            inputs = [inputs]
        if len(inputs) > 64:  # cap before tokenizing anything
            raise RequestError("at most 64 inputs per embeddings request")
        batches: List[List[int]] = []
        for item in inputs:
            if isinstance(item, str):
                ids = self.tokenizer.encode(item)
            elif isinstance(item, list) and all(isinstance(t, int) for t in item):
                ids = list(item)
            else:
                raise RequestError(
                    "'input' items must be strings or token arrays"
                )
            if not ids:
                raise RequestError("'input' items must not be empty")
            if len(ids) > self.mdc.context_length:
                raise RequestError(
                    f"input is {len(ids)} tokens; model context is "
                    f"{self.mdc.context_length}"
                )
            batches.append(ids)
        return {"embed_token_ids": batches}

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


def _jinja_raise(msg):
    raise jinja2.TemplateError(msg)
