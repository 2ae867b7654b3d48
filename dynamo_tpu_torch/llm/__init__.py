"""LLM pipeline pieces of the port: model cards, tokenization, pre- and
post-processing (copies of the JAX package's `llm/`)."""

from .backend import StreamPostprocessor, postprocess_stream
from .model_card import MODEL_ROOT, ModelDeploymentCard, RuntimeConfig
from .preprocessor import OpenAIPreprocessor, RequestError
from .tokenizer import HuggingFaceTokenizer, IncrementalDetokenizer

__all__ = [
    "MODEL_ROOT",
    "HuggingFaceTokenizer",
    "IncrementalDetokenizer",
    "ModelDeploymentCard",
    "OpenAIPreprocessor",
    "RequestError",
    "RuntimeConfig",
    "StreamPostprocessor",
    "postprocess_stream",
]
