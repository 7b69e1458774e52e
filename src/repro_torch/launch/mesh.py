"""Process groups and device meshes: the port of ``repro.launch.mesh``.

Kept as FUNCTIONS (never module-level constants) so importing this module
touches no process group and no device.

``mesh_axes`` keeps the reference's production sizes (a 16 x 16 mesh per
pod; two pods join the FSDP dimension as an outer "pod" axis): they are
inputs to the sharding rules, which the tests hold to the reference's at
those sizes. The port builds a ("data", "model") mesh over the ranks that
exist (``make_mesh``), after ``init_distributed`` has made the process
group; and, for the dry run (``repro_torch.launch.dryrun``), the pod's 16 x
16 or two pods' 2 x 16 x 16 mesh over a ``fake`` process group in one
process (``make_fake_mesh``), on which DTensors of ``meta`` tensors run
the sharded programs with no device and no traffic.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import BACKENDS
from repro_torch.kernels.runtime import require_device
from repro_torch.sharding.rules import MeshAxes


def mesh_axes(*, multi_pod: bool = False) -> MeshAxes:
    if multi_pod:
        return MeshAxes(fsdp=("pod", "data"), model="model", fsdp_size=32, model_size=16)
    return MeshAxes(fsdp=("data",), model="model", fsdp_size=16, model_size=16)


def init_distributed(rank: int, world_size: int, *, device=None, init_method=None,
                     store=None) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size``: NCCL
    when the device is CUDA (one rank per card: rank r takes cuda:r, and a
    rank past the machine's cards raises — NCCL refuses two ranks on one
    card), gloo on the CPU. Rendezvous through ``store`` (e.g. a
    ``dist.FileStore``) or ``init_method`` (e.g. "tcp://localhost:<port>").
    Returns the rank's device."""
    dev = require_device(device)
    if dev.type == "cuda":
        if rank >= torch.cuda.device_count():
            raise ValueError(f"rank {rank}: one rank per card, and this machine has "
                             f"{torch.cuda.device_count()}")
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    kwargs = {"store": store} if store is not None else {"init_method": init_method}
    dist.init_process_group(BACKENDS[dev.type], rank=rank, world_size=world_size, **kwargs)
    return dev


def make_mesh(data: int, model: int, device=None):
    """A (data, model) ``DeviceMesh`` with dim names ("data", "model") over
    the default group's data * model ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = require_device(device)
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def make_smoke_mesh(data: int = 2, model: int = 2, device=None):
    """The 2 x 2 mesh of the CPU tests (four gloo ranks)."""
    return make_mesh(data, model, device)


def make_fake_mesh(multi_pod: bool = False, shape: tuple[int, ...] | None = None):
    """The production mesh over a ``fake`` process group of this process
    alone: (16, 16) ("data", "model"), or with ``multi_pod`` (2, 16, 16)
    ("pod", "data", "model"); ``shape`` another (data, model) or (pod,
    data, model) size. Its collectives move nothing, so it carries DTensors
    of ``meta`` tensors only. A default group of another size or backend
    is replaced (it must be no real one: call this in a process of its
    own, never beside NCCL or gloo ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = tuple(shape or ((2, 16, 16) if multi_pod else (16, 16)))
    names = ("pod", "data", "model")[-len(shape):]
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return init_device_mesh("cpu", shape, mesh_dim_names=names)
        if dist.get_backend() != "fake":
            raise RuntimeError(f"make_fake_mesh: a {dist.get_backend()} group is live here")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def axes_of(mesh) -> MeshAxes:
    """The ``MeshAxes`` of a (data, model) mesh of ``make_mesh`` or a
    (pod, data, model) one: every dim but "model" joins fsdp, in order."""
    names = tuple(mesh.mesh_dim_names)
    fsdp = tuple(n for n in names if n != "model")
    size = 1
    for n in fsdp:
        size *= mesh.size(names.index(n))
    return MeshAxes(fsdp=fsdp, model="model", fsdp_size=size,
                    model_size=mesh.size(names.index("model")))
