from .ops import moe_mlp

__all__ = ["moe_mlp"]
