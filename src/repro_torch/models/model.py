"""Model facade: one object per architecture exposing

    init(generator, device)              → params
    loss(params, batch)                  → (loss, metrics)
    prefill(params, inputs, cache_len)   → (last_logits, caches)
    decode(params, token, caches, pos)   → (logits, caches)
    init_paged_caches / paged_decode     → the paged-KV decode step

as the JAX package's ``models/model.py`` does for the decoder LM (dense,
MoE, hybrid and RWKV-6 stacks, GQA or MLA attention; RWKV keeps recurrent
state instead of KV, a hybrid (Hymba) stack KV beside its Mamba state, MLA
a compressed latent cache; a vlm's (llava) ``prefill`` also reads
precomputed patch embeddings ``inputs["extra_embeds"]``) and for the
encoder-decoder family (Whisper:
``prefill`` reads ``inputs["frames"]`` and ``inputs["tokens"]``, the caches
are the decoder's self K/V and the cross-attention K/V, see
:mod:`.encdec`).  The
tensors' device is the device: params, inputs and caches stay where the
caller put them, and nothing moves to the CPU on its own.  Decode writes
the caches in place (what a CUDA graph of the step needs) and returns them.

``loss(params, batch, generator, remat)`` is the training loss of every
family.  Not ported: the dry-run helpers ``input_specs``,
``decode_state_specs`` and ``init_shapes`` (ROADMAP A10); they raise.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from ..configs.base import ModelConfig
from . import encdec as ed
from . import transformer as tf


class Model:
    def __init__(self, cfg: ModelConfig, use_kernels: bool = False):
        self.cfg = cfg
        self.use_kernels = use_kernels

    # -- params ---------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> Any:
        if self.cfg.family == "encdec":
            return ed.init_encdec(self.cfg, generator, device)
        return tf.init_lm(self.cfg, generator, device)

    # -- steps ------------------------------------------------------------------
    def prefill(self, params, inputs: Mapping[str, Any],
                cache_len: int | None = None):
        if self.cfg.family == "encdec":
            return ed.encdec_prefill(params, inputs["frames"],
                                     inputs["tokens"], self.cfg,
                                     cache_len or inputs["tokens"].shape[1],
                                     self.use_kernels)
        return tf.lm_prefill(params, inputs["tokens"], self.cfg, cache_len,
                             self.use_kernels, inputs.get("extra_embeds"))

    def decode(self, params, token: torch.Tensor, caches,
               pos: torch.Tensor):
        if self.cfg.family == "encdec":
            return ed.encdec_decode(params, token, caches, pos, self.cfg,
                                    self.use_kernels)
        return tf.lm_decode(params, token, caches, pos, self.cfg,
                            self.use_kernels)

    # -- paged decode ------------------------------------------------------------
    def supports_paged(self) -> bool:
        """Paged KV applies to pure-attention decoder stacks only (the
        encoder-decoder's caches stay dense, as in the reference)."""
        return self.cfg.family in ("dense", "moe", "vlm")

    def init_paged_caches(self, num_pages: int, page_size: int,
                          device: torch.device | str = "cuda"):
        return tf.init_paged_decode_caches(self.cfg, num_pages, page_size,
                                           device=device)

    def paged_decode(self, params, token: torch.Tensor, caches,
                     block_tables: torch.Tensor, pos: torch.Tensor):
        return tf.lm_paged_decode(params, token, caches, block_tables, pos,
                                  self.cfg, self.use_kernels)

    # -- training -----------------------------------------------------------------
    def loss(self, params, batch: Mapping[str, Any],
             generator: torch.Generator | None = None, remat: bool = False):
        """→ (loss, metrics) on ``batch`` (``tokens``, ``labels``; the
        encoder-decoder's ``frames``, a vlm's ``extra_embeds``).  The CUDA
        kernels have no backward: on the card the loss needs a model built
        with ``use_kernels=False``, as the trainer builds it, and raises
        otherwise.  ``generator`` feeds the router noise, ``remat``
        recomputes each layer in the backward."""
        if self.cfg.family == "encdec":
            return ed.encdec_loss(params, batch, self.cfg, generator,
                                  self.use_kernels, remat)
        return tf.lm_loss(params, batch, self.cfg, generator,
                          self.use_kernels, remat)

    # -- dry-run: not ported ----------------------------------------------------------

    def init_shapes(self, *args, **kwargs):
        raise NotImplementedError("dry-run param shapes are not ported yet "
                                  "(ROADMAP A10)")

    def input_specs(self, *args, **kwargs):
        raise NotImplementedError("dry-run input specs are not ported yet "
                                  "(ROADMAP A10)")

    def decode_state_specs(self, *args, **kwargs):
        raise NotImplementedError("dry-run decode state specs are not ported "
                                  "yet (ROADMAP A10)")


def make_model(cfg: ModelConfig, use_kernels: bool = False) -> Model:
    return Model(cfg, use_kernels)
