"""GPipe-style pipeline parallelism over a mesh dim: the JAX package's
``parallel/pipeline.py`` on ``torch.distributed``.

For multi-pod runs the ``pod`` dim can carry pipeline stages instead of
data parallelism (``ParallelConfig.pod_axis_role="pipeline"``): each pod
holds a contiguous slice of layers, and microbatches stream through with
point-to-point hand-offs.  Every rank runs :func:`pipeline_apply` (the
reference wraps it in ``shard_map``); the schedule is explicit.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map


def pipeline_apply(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,        # params with leading [n_stages, layers_per_stage, ...]
    x: torch.Tensor,          # [n_micro, mb, ...] microbatched input
    mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Run ``layer_fn`` stacks as a GPipe pipeline over ``axis``.

    Every rank holds the stacked params and the microbatches; stage ``s``
    (this rank's index along ``axis``) applies its layer slice to
    microbatch ``m`` at step ``t = s + m``, for ``n_stages + n_micro - 1``
    steps, and hands its output to stage ``s + 1``.  The last stage's
    outputs are broadcast to every stage (the reference's psum of the
    masked outputs) → [n_micro, mb, ...] on every rank."""
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    n_micro = x.shape[0]
    p_stage = tree_map(lambda a: a[sid], stage_params)
    n_layers = tree_leaves(p_stage)[0].shape[0]

    def active(stage: int, t: int) -> bool:
        return 0 <= t - stage < n_micro

    def apply_stack(h):
        for li in range(n_layers):
            h = layer_fn(tree_map(lambda a: a[li], p_stage), h)
        return h

    outs = torch.zeros_like(x)
    buf = torch.zeros_like(x[0])
    for t in range(n_stages + n_micro - 1):
        ops = []
        if sid > 0 and active(sid - 1, t - 1):
            # the hand-off stage sid - 1 posted at step t - 1
            buf = torch.empty_like(x[0])
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(group, sid - 1),
                                  group))
        for r in (dist.batch_isend_irecv(ops) if ops else []):
            r.wait()
        if not active(sid, t):
            continue
        m = t - sid
        h_out = apply_stack(x[t] if sid == 0 else buf)
        if sid == n_stages - 1:
            outs[m] = h_out
        else:
            for r in dist.batch_isend_irecv([dist.P2POp(
                    dist.isend, h_out.contiguous(),
                    dist.get_global_rank(group, sid + 1), group)]):
                r.wait()
    dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return outs


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro}")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])
