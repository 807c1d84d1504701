"""Performance flags: a copy of the JAX package's ``flags.py``.

Every optimization beyond the paper is off by default, so the
paper-faithful baseline stays the baseline.  The same environment
variables as the JAX package's turn them on, so one setting flips both
packages:

    REPRO_CACHE_UPDATE         where | scatter  decode KV-cache write policy
    REPRO_CHUNKED_CE           0 | 1            seq-chunked cross-entropy
    REPRO_CAUSAL_SKIP          0 | 1            skip fully-masked KV chunks
    REPRO_WINDOW_SLICE_DECODE  0 | 1            windowed decode reads w+1 slots
    REPRO_KV_QUANT             0 | 1            int8 MLA latent cache

Each function reads its variable when the code that consults it runs.
So a recorded CUDA graph (the serving engine's decode step, an op-graph
executable) keeps the values it was recorded with, as the JAX package's
jitted steps keep the values they were traced with: set a variable before
the engine or graph is built.

``REPRO_CACHE_UPDATE`` changes the JAX package's lowering of the decode
cache write (a where-select over the whole cache, or a one-slot scatter),
not its values.  The port writes the one slot in place under either value
(what a CUDA graph of the decode step needs), so both give the same bits;
any value but ``scatter`` means ``where``, as there.  The analytic cost
model (``launch/analytic_cost.py``) still reads it.
"""
from __future__ import annotations

import os


def cache_update_mode() -> str:
    return os.environ.get("REPRO_CACHE_UPDATE", "where")


def chunked_ce() -> bool:
    return os.environ.get("REPRO_CHUNKED_CE", "0") == "1"


def causal_skip() -> bool:
    return os.environ.get("REPRO_CAUSAL_SKIP", "0") == "1"


def window_slice_decode() -> bool:
    """Window-attention decode reads the ``window + 1`` cache slots it can
    attend instead of the whole cache under a mask."""
    return os.environ.get("REPRO_WINDOW_SLICE_DECODE", "0") == "1"


def kv_quant() -> bool:
    """int8 MLA latent cache with a per-token scale: halves the latent's
    storage and read traffic (KIVI/KVQuant-style, applied to the
    compressed latent)."""
    return os.environ.get("REPRO_KV_QUANT", "0") == "1"
