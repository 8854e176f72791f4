"""Device meshes of the port over ``torch.distributed`` (the counterpart of
``repro/launch/mesh.py``).

A mesh needs an initialized default process group of ``prod(shape)`` ranks:
one process per rank (``torch.distributed.init_process_group`` with its
address, ``tcp://localhost:<port>`` or ``file://<path>``, world size and
rank), or, for the dry run, one process holding a ``fake`` group of as
many ranks as the mesh (``FakeStore``). ``make_production_mesh`` is a
function, so importing this module touches no distributed state. Single
pod: (16, 16) = 256 ranks as (data, model); multi-pod: (2, 16, 16) = 512
ranks as (pod, data, model).
"""

from __future__ import annotations

import contextlib


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group's ranks. ``device_type`` is ``"cuda"`` unless given (the tests
    pass ``"cpu"``). DTensor on a CUDA mesh over gloo (ranks sharing one
    card, which NCCL refuses) runs inside ``gloo_cuda_all_gather``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def gloo_cuda_all_gather():
    """For the length of the block, the CUDA kernel of the functional
    collective ``_c10d_functional.all_gather_into_tensor`` is gloo's own
    ``all_gather_into_tensor`` (synchronous, so its result needs no wait);
    the registration is removed on exit, which puts the original kernel
    back. DTensor gathers through the functional op, which crashes the
    process (SIGSEGV) on CUDA tensors over gloo, while gloo's own call
    carries them (as it does all-reduce, reduce-scatter and all-to-all;
    found on an H100 with torch 2.11). For ranks whose default group is
    gloo and whose tensors are on the card; any other group is refused
    while the block runs."""
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        group = _resolve_process_group(group_name)
        if dist.get_backend(group) != "gloo":
            raise RuntimeError("gloo_cuda_all_gather: a group on "
                               f"{dist.get_backend(group)}, not gloo")
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    try:
        lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
        yield
    finally:
        lib._destroy()


# The production meshes, (shape, axes) by name: the dry run's cells and
# make_production_mesh read them here.
PRODUCTION_MESHES = {"single": ((16, 16), ("data", "model")),
                     "multi": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The dry run's mesh over the default process group: (16, 16)
    ``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")``."""
    shape, axes = PRODUCTION_MESHES["multi" if multi_pod else "single"]
    return make_test_mesh(shape, axes, device_type)


def dp_axes(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes (``pod`` and ``data``), in mesh
    order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
