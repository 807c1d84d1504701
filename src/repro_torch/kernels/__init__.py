"""Hand-written Hopper kernels: the capturer's fused GEMM routes and the
model facade's normalisation, attention, expert MLP and WKV recurrence.

Each kernel lives in its own subpackage, mirroring the JAX package:

    <name>/kernel.py   ctypes binding of the CUDA entry point in ``csrc/``
    <name>/ops.py      public wrapper: checks, allocation, launch count
    <name>/ref.py      plain PyTorch version (the CPU's path, and the
                       yardstick the kernel is held against on the card)

Kernels:
    branch_gemm    N equal-shape GEMMs in one launch — the Opara wave
    grouped_gemm   ragged-M grouped GEMM (unequal branch row counts, MoE
                   expert fan-out) over a device tile→group table
    rmsnorm        fused RMSNorm, fp32 statistics (``csrc/norm.cu``)
    flash_attention  causal/windowed GQA prefill with an online softmax
    decode_attention single-token decode against the dense KV slab
    paged_decode   single-token decode through a block table into KV pages
                   (the last three in ``csrc/attention.cu``; the two decode
                   kernels share one device routine), and its MLA form:
                   one latent KV head under all query heads
                   (``csrc/mla_decode.cu``)
    moe_gemm       grouped expert SwiGLU MLP over the MoE capacity buffers
                   (``csrc/moe.cu``)
    rwkv6          the WKV6 recurrence of RWKV-6's time mix: step by step with
                   the state on chip, or in parallel chunks (``csrc/rwkv6.cu``)

Backend rule (:func:`use_kernel`): tensors on the CPU take the plain
version; tensors on one CUDA device of compute capability 9.0 (Hopper)
launch the kernel; anything else raises.  There is no fallback from a CUDA
tensor to the plain version.
"""
from __future__ import annotations

import torch

TILE_M = 128  # rows of a grouped_gemm row tile; must equal TILE_M in
              # csrc/gemm.cu (checked when the library loads)
DECODE_TILE = 16     # KV positions per tile of the decode kernels' mma
                     # route (a split is a whole number of them); must equal
                     # DT in csrc/attention.cu (checked when the library
                     # loads)
DECODE_MAX_SPLITS = 16  # most splits of a (row, KV head) on the mma route
                        # (a cluster's blocks); must equal DM_MAX_SPLITS in
                        # csrc/attention.cu (checked when the library loads)
DECODE_CHUNK = 128   # KV positions per block of the decode kernels' simple
                     # and fp32 routes; must equal DEC_CHUNK in
                     # csrc/attention.cu (checked when the library loads)
MLA_TILE = 32        # KV positions per tile of the MLA decode's simple and
                     # fp32 routes; must equal CH in csrc/mla_decode.cu
                     # (checked when the library loads)
MLA_WGMMA_TILE = 64  # KV positions per tile of the MLA decode's wgmma route
                     # (a split is a whole number of them); must equal
                     # mla_wg::BKV in csrc/mla_decode.cu (checked when the
                     # library loads)
MLA_MAX_SPLITS = 8   # most splits of a (row, head group) on the MLA wgmma
                     # route (a cluster's blocks); must equal
                     # mla_wg::MAX_SPLITS in csrc/mla_decode.cu (checked
                     # when the library loads)
MOE_MAX_EXPERTS = 4096  # most experts of moe_gemm's wgmma route (its list of
                       # active experts lives in shared memory); must equal
                       # MAX_EXPERTS in csrc/moe.cu (checked when the library
                       # loads)
RWKV6_MAX_K = 64     # largest head size of the rwkv6 kernel; must equal KMAX
                     # in csrc/rwkv6.cu (checked when the library loads)
RWKV6_CHUNK = 64     # positions per chunk of rwkv6's chunked route; must
                     # equal L in csrc/rwkv6.cu (checked when the library
                     # loads)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """``False`` when every tensor lies on the CPU, ``True`` when all lie on
    one Hopper CUDA device; raises for mixed devices or another card."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors on mixed devices {sorted(map(str, devices))}")
    device = next(iter(devices))
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} is sm_{major}{minor}; the "
            "kernels are built for sm_90a (Hopper) only")
    return True
