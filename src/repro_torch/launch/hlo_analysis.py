"""Collective traffic, FLOPs and memory of one lowered step: the JAX
package's ``launch/hlo_analysis.py``.

The reference parses compiled HLO text.  Its parser is kept here as a copy
(``_DTYPE_BYTES``, ``_COLLECTIVES`` with the ring factors,
:class:`CollectiveStats`, :func:`parse_collectives`), so the port reads a
reference dump as the reference does.

The port has no HLO: a ``DTensor`` step runs op by op.  :class:`StepCounter`
is a dispatch mode that watches the ops each rank runs on its local shards
(it lets ``DTensor`` desugar every op into local ops and collectives first)
and reckons, for rank 0:

* collectives — each ``_c10d_functional`` op (and a point-to-point send)
  as the reference's kind: all_reduce → all-reduce, all_gather_into_tensor
  → all-gather, reduce_scatter_tensor → reduce-scatter, all_to_all_single
  → all-to-all, send → collective-permute; its per-device output bytes ×
  the kind's ring factor, summed into a :class:`CollectiveStats`;
* ``flops`` — ``torch.utils.flop_counter``'s count of every local op:
  per device, replicated work counted on every device, as XLA's
  ``cost_analysis`` of an SPMD program counts it;
* ``bytes accessed`` — the tensor operand and result bytes of every local
  op that makes a new tensor (views move nothing), XLA's key of that name
  reckoned op by op, with no fusion;
* memory — argument and output bytes from the local shard shapes, and a
  temp figure: the peak bytes of the tensors the mode saw made and still
  alive.  That last is the port's own reckoning (no allocator, no
  aliasing, no fusion) and is not comparable with XLA's
  ``temp_size_in_bytes``.

The port's layers are a Python loop, so every layer's collectives are seen
and no scan-depth multiplier applies.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = {
    "all-reduce": 2.0,          # ring: 2(n-1)/n ≈ 2×
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_SHAPE_RE = re.compile(r"(f64|f32|f16|bf16|f8e4m3fn|f8e5m2|s64|u64|s32|u32|s16|u16|s8|u8|pred)\[([0-9,]*)\]")


def _shape_bytes(tok_dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[tok_dtype]


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, float]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def parse_collectives(hlo_text: str, while_multiplier: float = 1.0) -> CollectiveStats:
    """Sum weighted output bytes of collective ops in (optimized) HLO text.

    ``while_multiplier`` scales collectives found inside computations that a
    while loop calls (scan bodies) — pass the stack depth when known.
    HLO computations print as blocks; we detect body computations by their
    name containing "while" or "body" (XLA's scan lowering convention).
    """
    bytes_by: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    count_by: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    in_while_body = False
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # computation headers look like: `%name (param: ...) -> ... {` or `ENTRY`
        if stripped.endswith("{") and ("(" in stripped):
            header = stripped.split("(")[0]
            in_while_body = ("while" in header or "body" in header or
                             "cond" in header) and "ENTRY" not in header
            continue
        for kind, weight in _COLLECTIVES.items():
            # match op occurrence, skipping async -done halves
            if f" {kind}(" in stripped or f" {kind}-start(" in stripped:
                lhs = stripped.split(f" {kind}")[0]
                total = sum(_shape_bytes(d, s) for d, s in _SHAPE_RE.findall(lhs))
                mult = while_multiplier if in_while_body else 1.0
                bytes_by[kind] += weight * total * mult
                count_by[kind] += 1
                break
    return CollectiveStats(bytes_by, count_by)


# -- the torch half: a dispatch mode over the local ops ------------------------

# op name (``_c10d_functional`` or ``c10d``) → the reference's HLO kind
_TORCH_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree_leaves: list) -> float:
    """Bytes of the local shards of ``DTensor`` leaves (whole tensors
    otherwise): what one device holds."""
    from torch.distributed.tensor import DTensor
    total = 0
    for x in tree_leaves:
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += _nbytes(x)
    return float(total)


class StepCounter(TorchDispatchMode):
    """Counts one rank's collectives, FLOPs and live temporaries while a
    step runs under it (``with StepCounter() as c: step(...)``)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.bytes_by_kind = {k: 0.0 for k in _COLLECTIVES}
        self.count_by_kind = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if (isinstance(func, torch._ops.HigherOrderOperator)
                or torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None):
            # DTensor's sharding propagation runs the op on fake tensors
            # of the global shapes: not work any device does
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar the op into local ops and collectives
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += float(self._flops[packet](*args, **kwargs,
                                                    out_val=out))
        ns, _, name = packet._qualified_op_name.partition("::")
        kind = (_TORCH_KINDS.get(name)
                if ns in ("_c10d_functional", "c10d") else None)
        if kind is not None:
            first = out[0] if isinstance(out, (list, tuple)) else out
            src = args[0] if kind == "collective-permute" else first
            if isinstance(src, (list, tuple)):
                src = src[0]
            if isinstance(src, torch.Tensor):
                self.bytes_by_kind[kind] += _COLLECTIVES[kind] * _nbytes(src)
                self.count_by_kind[kind] += 1
        made = [t for t in (out if isinstance(out, (list, tuple)) else (out,))
                if isinstance(t, torch.Tensor) and t._base is None]
        if made:
            self.bytes_accessed += sum(
                _nbytes(a) for a in list(args) + list(kwargs.values())
                if isinstance(a, torch.Tensor)) + sum(map(_nbytes, made))
        for t in made:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes_by_kind),
                               dict(self.count_by_kind))


def cost_dict(counter: StepCounter) -> dict[str, float]:
    """The counter's FLOPs and bytes accessed, per device, under the
    reference's ``cost_analysis`` keys."""
    return {"flops": counter.flops, "bytes accessed": counter.bytes_accessed}


def memory_dict(counter: StepCounter, args: list, outputs: list
                ) -> dict[str, float]:
    """Per-device bytes of the step's arguments and outputs (local shard
    shapes) and the counter's peak of live temporaries."""
    return {"argument_size_in_bytes": local_bytes(args),
            "output_size_in_bytes": local_bytes(outputs),
            "temp_size_in_bytes": float(counter.peak)}
