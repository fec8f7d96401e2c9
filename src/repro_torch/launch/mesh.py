"""Production mesh factory (port of ``repro/launch/mesh.py``).

A function, not a module-level constant: importing this module touches no
process group. Each mesh is a ``DeviceMesh`` over the current default
process group (``init_device_mesh``), so the group must hold as many ranks
as the mesh has devices: the dry-run makes a fake group of 256 or 512
ranks (``compat.init_fake_process_group``), the tests a gloo group of 8,
the card one NCCL rank.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16)
    ``("pod", "data", "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, *, device_type: str = "cpu"):
    """Arbitrary mesh (tests, examples, degraded pools)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
