"""LM serving on the port: the continuous-batching engine and sampling."""

from .engine import InferenceEngine, Request, ServeConfig
from .sampling import restrict_vocab, sample_token

__all__ = ["InferenceEngine", "Request", "ServeConfig", "restrict_vocab",
           "sample_token"]
