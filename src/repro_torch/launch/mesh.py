"""Production meshes: the JAX package's ``launch/mesh.py`` on
``torch.distributed.device_mesh``.

Functions, not module constants, so importing this module touches no
process group.  A mesh needs a default process group of its size:

* on the card, one NCCL rank per GPU (``init_process_group("nccl", ...)``
  by the caller), ``device_type="cuda"``;
* in CPU tests, gloo ranks (``device_type="cpu"``);
* in the dry-run, :func:`fake_world`: one process standing in for all 512
  ranks of a fake process group, whose collectives do nothing.  The
  dry-run's tensors live on the meta device (shapes and dtypes, no
  storage), so its mesh is ``"cpu"`` and it needs no card, as the
  reference's 512 host placeholder devices need no TPU.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16×16 = 256 chips a pod; multi-pod adds a leading 2-pod dim."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    multi_pod: bool = False,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small mesh over the default group's ranks (gloo in CPU tests, one
    NCCL rank on one card)."""
    if multi_pod:
        return init_device_mesh(device_type, (2, n_data, n_model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Data-parallel mesh dims: ('pod','data') on multi-pod, else ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _fake_store():
    # FakeStore lives in a private module of torch's test utilities; the
    # fake backend registers itself when it is imported
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                            # pragma: no cover
        import torch
        raise RuntimeError(
            "torch.testing._internal.distributed.fake_pg.FakeStore is not "
            f"in torch {torch.__version__}; the dry-run's fake world needs "
            "it") from e
    return FakeStore()


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks held by this one
    process (rank 0), whose collectives return at once without moving
    data: ``DTensor`` propagation, its redistribution plans and the
    collective counters run as on the real mesh.  Torn down on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
