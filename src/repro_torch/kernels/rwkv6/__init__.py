from .ops import rwkv6, rwkv6_model

__all__ = ["rwkv6", "rwkv6_model"]
