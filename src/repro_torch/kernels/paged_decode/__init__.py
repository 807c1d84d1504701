from .ops import (paged_decode_attention, paged_mla_decode_attention,
                  paged_mla_decode_simple_bf16)
from .ref import paged_decode_attention_ref, paged_mla_decode_attention_ref

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "paged_mla_decode_attention", "paged_mla_decode_attention_ref",
           "paged_mla_decode_simple_bf16"]
