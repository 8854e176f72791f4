"""Device meshes of the port over ``torch.distributed`` (the counterpart of
``repro/launch/mesh.py``'s ``make_test_mesh`` and ``dp_axes``).

A mesh needs an initialized default process group of ``prod(shape)`` ranks,
one process per rank: ``torch.distributed.init_process_group`` with its
address (``tcp://localhost:<port>`` or ``file://<path>``), world size and
rank, then ``make_test_mesh`` on every rank. Nothing here touches the
distributed state at import time.
"""

from __future__ import annotations


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group's ranks. ``device_type`` is ``"cuda"`` unless given (the tests
    pass ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


def dp_axes(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes (``pod`` and ``data``), in mesh
    order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
