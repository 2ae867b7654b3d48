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

The encode worker (`disagg/encode.py` in the JAX package) comes with the
vision slice.
"""

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
    "PREFILL_COMPONENT",
    "DisaggDecodeHandler",
    "DisaggRouter",
    "KvLayout",
    "KvTransferClient",
    "KvTransferSource",
    "PrefillFacade",
    "RemoteRouterClient",
    "lookup_layouts",
    "serve_prefill_worker",
]
