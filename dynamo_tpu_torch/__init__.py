"""dynamo_tpu_torch — the PyTorch/CUDA port of dynamo_tpu for one NVIDIA H100.

The JAX package (`dynamo_tpu`) is the reference; this package imports
`torch` and never `jax`, and nothing of `dynamo_tpu`.  It carries its own
copies of the host modules it needs (config, page pool, scheduler, block
hashing, the runtime, worker, OpenAI frontend and LLM pipeline) and its
own stdlib stand-ins for packages the GPU machine lacks (tokenizer,
safetensors reader, msgpack codec, HTTP server, Prometheus exposition).
The two Pallas paged-attention kernels of the JAX package are
hand-written CUDA kernels here (`csrc/paged_attention.cu`), and so is the
MoE grouped GEMM that stands for its `jax.lax.ragged_dot`
(`csrc/grouped_gemm.cu`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # imported on first use: the control plane and the frontend processes
    # import no torch
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
