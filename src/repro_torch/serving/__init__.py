"""Serving tier of the port: the continuous-batching engine, its admission
tier, the KV page pool and the sampler."""
from .admission import (AdmissionConfig, AdmissionQueue, Request,
                        RequestState, TERMINAL_STATES)
from .engine import InferenceEngine
from .kv_pool import (KVPagePool, KVPoolConfig, PageExhausted,
                      page_content_keys)
from .sampler import sample_token

__all__ = ["InferenceEngine", "Request", "RequestState", "AdmissionConfig",
           "AdmissionQueue", "TERMINAL_STATES", "sample_token",
           "KVPagePool", "KVPoolConfig", "PageExhausted",
           "page_content_keys"]
