"""Reference params → the port's tree.

:func:`from_numpy` turns a nested dict/list of numpy arrays (the JAX
package's params after ``jax.tree_util.tree_map(np.asarray, params)``) into
the same tree of tensors on ``device``.  bf16 arrays (``ml_dtypes``'
``bfloat16``, which ``torch.from_numpy`` refuses) go through their int16
bits, so the conversion is bit-exact.  :func:`adamw_state_from_numpy`
does the same for the reference's optimizer state, so both packages can
start a training step from one state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .models.layers import check_device


def array_to_tensor(a: Any, device: torch.device | str = "cuda") -> torch.Tensor:
    arr = np.array(a, order="C")      # a writable copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(check_device(device))


def from_numpy(tree: Any, device: torch.device | str = "cuda") -> Any:
    """Same nesting, every array leaf a tensor on ``device``; a NamedTuple
    is rebuilt field by field, ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(from_numpy(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return array_to_tensor(tree, device)


def adamw_state_from_numpy(state: Any,
                           device: torch.device | str = "cuda"):
    """The reference's ``AdamWState(step, mu, nu)`` with numpy leaves (after
    ``jax.tree_util.tree_map(np.asarray, state)``) → the port's
    :class:`repro_torch.optim.AdamWState`: the int32 step and the fp32
    moment trees as tensors on ``device``."""
    from .optim import AdamWState
    return AdamWState(step=array_to_tensor(state.step, device),
                      mu=from_numpy(state.mu, device),
                      nu=from_numpy(state.nu, device))
