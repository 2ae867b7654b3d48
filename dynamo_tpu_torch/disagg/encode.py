"""EPD (encode / prefill / decode) split: the encode worker role (the JAX
package's `disagg/encode.py`).

- `serve_encode_worker` serves an engine's vision tower at
  ``{ns}.encoder.generate`` (card role ``encode``: frontends skip it).  A
  request carries ``mm_pixels`` (a CLIP tower) or ``mm_patches`` (a Qwen
  tower); the answer carries the projected embeddings as ``mm_embeds``
  (one [N, P, h] blob, or one [P_i, h] blob per medium with its grid) and
  the media's cache salt.  The tower runs on the engine's step thread
  between steps (`TorchEngine._device_op`).
- `EncodeOffload` wraps a serving engine that carries no tower (only the
  tower's geometry, for M-RoPE): media requests detour to the encode
  component and continue with ``mm_embeds`` in place of the media,
  invisible to the frontend.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..llm.multimodal import unpack_patches, unpack_pixels
from ..models.qwen_vl import Qwen2VLVisionConfig, encode_patches
from ..models.vision import VisionConfig, encode_images
from ..runtime import Context, DistributedRuntime

logger = logging.getLogger(__name__)

ENCODE_COMPONENT = "encoder"


def _blob(a: torch.Tensor, grid=None) -> Dict[str, Any]:
    arr = np.ascontiguousarray(a.float().cpu().numpy())
    out = {"shape": list(arr.shape), "data": arr.tobytes()}
    if grid is not None:
        out["grid"] = [int(g) for g in grid]
    return out


async def encode_media(engine, request: Dict[str, Any]) -> Dict[str, Any]:
    """Run `engine`'s tower over a request's media → {"mm_embeds",
    "cache_salt"} or {"error"}."""
    if engine.vision is None or engine.vision[0] is None:
        return {"error": "this worker has no vision tower attached"}
    tower, vcfg = engine.vision
    h = hashlib.blake2b(digest_size=8)
    try:
        if request.get("mm_patches"):
            if not isinstance(vcfg, Qwen2VLVisionConfig):
                return {"error": "mm_patches requires a qwen2_vl vision tower"}
            media = [unpack_patches(b) for b in request["mm_patches"]]
            for arr, (t, gh, gw) in media:
                if arr.ndim != 2 or arr.shape != (t * gh * gw, vcfg.patch_dim):
                    return {"error": "patch count does not match the grid"}
                h.update(np.ascontiguousarray(arr).tobytes())

            def op():
                return [_blob(encode_patches(tower, torch.from_numpy(np.array(a)), g), g)
                        for a, g in media]
        else:
            if not isinstance(vcfg, VisionConfig):
                return {"error": "this worker's vision tower takes mm_patches"}
            pixels = np.array(unpack_pixels(request["mm_pixels"]))
            if pixels.ndim != 4 or pixels.shape[1:] != (vcfg.image_size,
                                                        vcfg.image_size, 3):
                return {"error": f"image shape {pixels.shape[1:]} != tower input "
                                 f"({vcfg.image_size}, {vcfg.image_size}, 3)"}
            h.update(pixels.tobytes())

            def op():
                return _blob(encode_images(tower, torch.from_numpy(pixels).to(
                    tower.device)))
    except (KeyError, TypeError, ValueError):
        return {"error": "malformed media payload"}
    embeds = await engine._device_op(op)
    # the media's hash: the salt the serving worker would derive itself
    return {"mm_embeds": embeds, "cache_salt": h.hexdigest()}


async def serve_encode_worker(runtime: DistributedRuntime, engine, mdc,
                              namespace: str = "dynamo",
                              component: str = ENCODE_COMPONENT):
    """Serve the engine's tower as a standalone encode worker at
    {ns}.{component}.generate; serving workers' ``--encode-component``
    must name the same component."""
    from ..worker import serve_engine

    class EncodeFacade:
        """Every request is an encode request."""

        def __init__(self, engine):
            self.engine = engine

        async def generate(self, request, context):
            yield await encode_media(self.engine, request)

        async def shutdown(self):
            await self.engine.shutdown()

        def metrics(self):
            return self.engine.metrics()

        def clear_kv_blocks(self):
            return self.engine.clear_kv_blocks()

    mdc.disagg_role = "encode"
    facade = EncodeFacade(engine)
    await serve_engine(runtime, facade, mdc, namespace=namespace,
                       component=component, publish_kv_events=False)
    return facade


class EncodeOffload:
    """Wraps a serving engine: media requests detour to the encode
    component for their embeddings, so this worker carries no tower.
    Everything else delegates."""

    def __init__(self, engine, runtime: DistributedRuntime,
                 namespace: str = "dynamo", component: str = ENCODE_COMPONENT):
        self.engine = engine
        self.client = (runtime.namespace(namespace).component(component)
                       .endpoint("generate").client())
        self._started = False

    async def _encode(self, request: Dict[str, Any]) -> Dict[str, Any]:
        if not self._started:
            await self.client.start()
            await self.client.wait_for_instances()
            self._started = True
        key = "mm_patches" if request.get("mm_patches") else "mm_pixels"
        resp = None
        async for out in self.client.round_robin(
                {key: request[key], "mm_offsets": request.get("mm_offsets") or []},
                Context()):
            resp = out
            break
        return resp or {"error": "encode worker returned nothing"}

    async def generate(self, request: Dict[str, Any],
                       context: Optional[Context] = None):
        if request.get("mm_pixels") or request.get("mm_patches"):
            resp = await self._encode(request)
            if resp.get("error"):
                yield {"token_ids": [], "finish_reason": "error",
                       "error": f"encode worker: {resp['error']}"}
                return
            request = {k: v for k, v in request.items()
                       if k not in ("mm_pixels", "mm_patches")}
            request["mm_embeds"] = resp["mm_embeds"]
            if not request.get("cache_salt"):
                request["cache_salt"] = resp.get("cache_salt", "")
        async for out in self.engine.generate(request, context):
            yield out

    # -- delegation ------------------------------------------------------ #

    def metrics(self):
        return self.engine.metrics()

    def clear_kv_blocks(self):
        return self.engine.clear_kv_blocks()

    def add_event_sink(self, sink):
        self.engine.add_event_sink(sink)

    async def shutdown(self):
        if self._started:
            await self.client.stop()
        await self.engine.shutdown()
