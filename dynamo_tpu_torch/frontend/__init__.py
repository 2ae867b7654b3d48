"""OpenAI frontend of the port: HTTP service, model discovery, serving
pipelines (copies of the JAX package's `frontend/`)."""

from .metrics import FrontendMetrics
from .openai_http import HttpService
from .service import ModelEntry, ModelManager, ModelWatcher, register_llm

__all__ = [
    "FrontendMetrics",
    "HttpService",
    "ModelEntry",
    "ModelManager",
    "ModelWatcher",
    "register_llm",
]
