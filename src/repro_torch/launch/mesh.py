"""Production and host meshes as ``DeviceMesh`` builders (port of
``repro.launch.mesh``).  Functions, so that importing this module touches
no process group; each needs a default group of exactly the mesh's size
(the ``fake`` backend builds the production meshes in one process)."""
from __future__ import annotations

from typing import Any

import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> Any:
    """Single pod: 16 x 16 = 256 ranks (data, model).  Multi-pod: 2 pods x
    256 = 512 ranks (pod, data, model); the pod axis is data-parallel
    across pods (or pipeline stages)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str | None = None) -> Any:
    """A small mesh over the ranks of the default group (tests, examples,
    ``launch.train --mesh DxM``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def init_from_env(device: str) -> tuple[int, int]:
    """Join the process group ``torchrun`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on
    "cuda", each rank on the card of its local rank, gloo on "cpu".
    Returns (rank, world size)."""
    import os

    import torch

    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--mesh runs under torchrun (python -m "
                           "torch.distributed.run --nproc-per-node N ...)")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def mesh_from_flag(flag: str, world: int, device: str) -> Any:
    """The mesh a launcher's ``--mesh`` names: "auto" the best 2-D mesh
    for the world (``ft.elastic.make_mesh_for``), "DxM" a (data, model)
    host mesh, "production" / "multi_pod" the pod meshes."""
    import torch

    device_type = torch.device(device).type
    if flag == "auto":
        from repro_torch.ft.elastic import make_mesh_for
        return make_mesh_for(world, device_type=device_type)
    if flag in ("production", "multi_pod"):
        return make_production_mesh(multi_pod=flag == "multi_pod",
                                    device_type=device_type)
    try:
        shape = tuple(int(v) for v in flag.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2:
        raise ValueError(f"--mesh {flag!r}: auto, production, multi_pod "
                         f"or DxM")
    if shape[0] * shape[1] != world:
        raise ValueError(f"--mesh {flag}: {shape[0] * shape[1]} ranks, "
                         f"the world has {world}")
    return make_host_mesh(shape, device_type=device_type)
