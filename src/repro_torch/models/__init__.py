"""Model code of the port: the dense LM's init, prefill and decode behind
the :class:`Model` facade, and its operator-graph exporter."""
from .model import Model, make_model

__all__ = ["Model", "make_model"]
