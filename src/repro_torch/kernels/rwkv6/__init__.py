from .ops import rwkv6, rwkv6_model, rwkv6_step

__all__ = ["rwkv6", "rwkv6_model", "rwkv6_step"]
