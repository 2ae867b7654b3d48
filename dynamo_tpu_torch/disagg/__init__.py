"""Disaggregated prefill/decode serving (the port's copy of the JAX
package's `disagg/`).

- prefill workers serve `{ns}.prefill.generate`: their facade runs
  `TorchEngine.prefill_remote` (prompt compute, first token, pages held
  under a transfer handle) and answers with a transfer descriptor;
- decode workers wrap their engine in `DisaggDecodeHandler`: per request a
  `DisaggRouter` decides local vs remote by uncached prompt length, prefill
  queue depth and prefill worker availability; the remote path asks a
  prefill worker (through a standalone router service when one is named,
  else round-robin), fetches the pages through the block-ID data plane
  (`transfer.py`: colocated, CUDA IPC or host lane) and adopts them with
  `generate_imported`; any failure prefills locally and is counted;
- the device lanes move pages with one hand-written re-page kernel
  (`device_transfer.py`, `ops/kv_transfer.py`, `csrc/kv_transfer.cu`).

- the encode worker role (`encode.py`): a worker that runs only the
  vision tower, and `EncodeOffload`, which sends a serving worker's media
  to it.
"""

from .encode import ENCODE_COMPONENT, EncodeOffload, serve_encode_worker
from .handler import (
    PREFILL_COMPONENT,
    DisaggDecodeHandler,
    PrefillFacade,
    RemoteRouterClient,
    serve_prefill_worker,
)
from .router import DisaggRouter
from .transfer import KvLayout, KvTransferClient, KvTransferSource, lookup_layouts

__all__ = [
    "ENCODE_COMPONENT",
    "EncodeOffload",
    "PREFILL_COMPONENT",
    "DisaggDecodeHandler",
    "DisaggRouter",
    "KvLayout",
    "KvTransferClient",
    "KvTransferSource",
    "PrefillFacade",
    "RemoteRouterClient",
    "lookup_layouts",
    "serve_encode_worker",
    "serve_prefill_worker",
]
