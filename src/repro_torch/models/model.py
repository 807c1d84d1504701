"""Model facade: one object per architecture exposing

    init(generator, device)              → params
    loss(params, batch)                  → (loss, metrics)
    prefill(params, inputs, cache_len)   → (last_logits, caches)
    decode(params, token, caches, pos)   → (logits, caches)
    init_paged_caches / paged_decode     → the paged-KV decode step
    init_shapes()                        → param tree on the meta device
    input_specs(cell)                    → meta tensors of the cell's inputs
    decode_state_specs(cell)             → meta tensors of its decode caches

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
family.  The dry-run helpers build on the ``meta`` device, where a tensor
has a shape and a dtype and no storage, as ``jax.eval_shape`` gives the
JAX package's: full configs (DeepSeek-V3's 671 B params) cost nothing, and
the decode state follows the ``kv_quant`` flag.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from ..configs.base import ModelConfig, ShapeCell
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

    def init_shapes(self) -> Any:
        """The param tree on the meta device: shapes and dtypes, no
        storage (the dry-run)."""
        return self.init(torch.Generator(), "meta")

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

    # -- dry-run input specs -----------------------------------------------------
    def input_specs(self, cell: ShapeCell) -> dict[str, torch.Tensor]:
        """Meta tensors standing in for every model input of this cell."""
        cfg = self.cfg
        b, s = cell.global_batch, cell.seq_len
        i32 = torch.int32
        if cell.step == "decode":
            # one new token against a seq_len-long cache
            return {"token": _spec((b,), i32), "pos": _spec((b,), i32)}
        fe = cfg.frontend
        if cfg.family == "encdec":
            out = {"frames": _spec((b, fe.n_tokens, fe.feat_dim), cfg.dtype),
                   "tokens": _spec((b, s), i32)}
        else:
            out = {"tokens": _spec((b, self._text_len(s)), i32)}
        if cell.step == "train":
            out["labels"] = _spec(out["tokens"].shape, i32)
        if cfg.family == "vlm":
            out["extra_embeds"] = _spec((b, fe.n_tokens, fe.feat_dim),
                                        cfg.dtype)
        return out

    def _text_len(self, s: int) -> int:
        """VLM text token count: total seq budget minus image patches."""
        if self.cfg.family == "vlm" and self.cfg.frontend is not None:
            return max(s - self.cfg.frontend.n_tokens, 16)
        return s

    def decode_state_specs(self, cell: ShapeCell) -> Any:
        """The decode caches of this cell on the meta device: the encoder-
        decoder's ``(self K/V, cross K/V)``, the LM's per-stack caches
        (under ``kv_quant`` an MLA stack's int8 triple)."""
        cfg = self.cfg
        b = cell.global_batch
        length = cell.seq_len + cfg.meta_tokens
        if cfg.family == "encdec":
            n_dec = cfg.n_dec_layers or cfg.n_layers
            kvh, hd = cfg.n_kv_heads, cfg.head_dim

            def kv(t):
                return tuple(_spec((n_dec, b, t, kvh, hd), cfg.dtype)
                             for _ in range(2))
            return (kv(length), kv(cfg.frontend.n_tokens))
        return tf.init_decode_caches(cfg, b, length, device="meta")


def _spec(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def make_model(cfg: ModelConfig, use_kernels: bool = False) -> Model:
    return Model(cfg, use_kernels)
