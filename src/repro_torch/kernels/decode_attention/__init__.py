from .ops import decode_attention

__all__ = ["decode_attention"]
