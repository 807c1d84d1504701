from .ops import rmsnorm

__all__ = ["rmsnorm"]
