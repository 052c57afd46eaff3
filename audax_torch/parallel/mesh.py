"""The device mesh over ``torch.distributed`` ranks (port of
``audax/parallel/mesh.py``).

One process drives one rank. ``make_mesh`` lays the world's ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` with the axis names ("data",
"model"); its named sub-groups take the place of JAX's mesh axes:

  data      -- batch dim of inputs; gradients all-reduced across it
  model     -- TP axis: attention heads / FFN hidden sharded across it
  dcn_data  -- (multi-host) outer DP axis laid out across hosts, so its
               all-reduces cross hosts while data/model stay inside one
  seq       -- sequence parallelism: the encoder's frames cut across it
               (``parallel/sp.py``)
  stage     -- pipeline parallelism: the layer stack cut across it
               (``parallel/pp.py``)

``make_named_mesh`` builds any layout of those names, as the JAX package
builds its SP meshes ("data", "seq") and ("data", "model", "seq") and its
PP meshes ("stage",) and ("stage", "data") with ``Mesh(devices, names)``.

Where JAX's GSPMD inserts the collectives from the shardings, the port
writes them where they belong (``parallel/comm.py``); the mesh only names
the groups. ``use_mesh`` makes a mesh current for the model code, whose
collectives read it.

The backend follows the device: a mesh over CUDA ranks initialises NCCL
for CUDA tensors (and gloo for CPU ones), a CPU mesh gloo. A caller that
wants another backend (two ranks on one card must use gloo: NCCL refuses
two ranks on one GPU) initialises the process group itself before
``make_mesh``. ``init_distributed`` reads ``torchrun``'s environment; a
mesh asked for without an initialised group starts a world of one.
"""

from __future__ import annotations

import math
import os
import socket
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from audax_torch.core.config import MeshConfig
from audax_torch.core.runtime import DeviceLike, resolve_device

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_batch", "P",
           "local_mesh", "pad_to_multiple", "init_distributed",
           "make_multihost_mesh", "multihost_device_grid", "use_mesh",
           "current_mesh", "axis_size", "axis_rank", "axis_group",
           "batch_axes", "batch_size", "batch_rank", "batch_group",
           "mesh_device", "backend_for", "make_named_mesh", "block_of"]


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor dim, as
    ``jax.sharding.PartitionSpec``; trailing dims missing from it are
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


_CURRENT: ContextVar = ContextVar("audax_torch_mesh", default=None)


def backend_for(device: torch.device) -> str:
    """The process-group backend a mesh over ``device`` initialises: NCCL
    for CUDA tensors with gloo beside it for CPU ones, or gloo alone."""
    return "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: DeviceLike = None) -> int:
    """Join the process group of a ``torchrun`` launch; returns the world
    size.

    Arguments default to torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT`` as ``tcp://`` address, ``WORLD_SIZE``, ``RANK``;
    ``LOCAL_RANK`` picks the card ``cuda:LOCAL_RANK``). Without them this is
    a no-op that returns 1, so the same entry points run unmodified in one
    process. ``device="cpu"`` joins with gloo and touches no card."""
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = (f"tcp://{env['MASTER_ADDR']}:"
                       f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator is None and num_processes is None:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(dev),
                            init_method=coordinator,
                            world_size=num_processes or 1,
                            rank=process_id or 0)
    return dist.get_world_size()


def _ensure_world(device: torch.device) -> int:
    """The world size, starting a world of one (on a free localhost port)
    when no process group is initialised. A CUDA mesh selects this rank's
    card first (``LOCAL_RANK``, else the current one), so the NCCL
    communicators and the mesh's groups open on it."""
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else int(os.environ.get(
                                  "LOCAL_RANK", torch.cuda.current_device())))
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device),
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    return dist.get_world_size()


def _device_mesh(device: torch.device, ranks: np.ndarray,
                 names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(device.type, torch.as_tensor(ranks),
                      mesh_dim_names=tuple(names))
    mesh.audax_device = device           # where this rank's tensors live
    return mesh


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence[int]] = None, *,
              device: DeviceLike = None):
    """Build a (data, model) mesh over the world's ranks.

    ``data=-1`` absorbs every rank not claimed by the model axis. The
    model axis is the fastest-varying one, so a TP group is consecutive
    ranks (one host's cards under torchrun). ``devices``: the ranks to lay
    out (default all); "devices present" is the world size. The port runs
    one process per rank, so the mesh must cover the world: a smaller mesh
    would leave ranks with nothing to run."""
    cfg = cfg or MeshConfig()
    dev = resolve_device(device)
    world = _ensure_world(dev)
    devs = list(devices if devices is not None else range(world))
    model = max(1, cfg.model)
    if len(devs) % model != 0:
        raise ValueError(f"{len(devs)} devices not divisible by model={model}")
    data = cfg.data if cfg.data > 0 else len(devs) // model
    if data * model > len(devs):
        raise ValueError(f"mesh ({data} data x {model} model) needs "
                         f"{data * model} devices, only {len(devs)} present")
    if data * model != world:
        raise ValueError(f"mesh ({data} data x {model} model) covers "
                         f"{data * model} of the world's {world} ranks; one "
                         "process runs each rank, so the mesh must cover "
                         "them all")
    arr = np.array(devs[: data * model]).reshape(data, model)
    return _device_mesh(dev, arr, cfg.axis_names)


def make_named_mesh(axes: Sequence[Tuple[str, int]], *,
                    device: DeviceLike = None):
    """A mesh of the named ``axes`` ((name, size) pairs, outermost first;
    one size may be -1 to take the ranks the others leave) over the
    world's ranks in row-major order, so the last axis varies fastest. The
    mesh must cover the world (one process runs each rank)."""
    dev = resolve_device(device)
    world = _ensure_world(dev)
    names = tuple(a for a, _ in axes)
    sizes = [int(n) for _, n in axes]
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} repeat a name")
    known = math.prod(n for n in sizes if n > 0)
    if sizes.count(-1) > 1 or any(n == 0 or n < -1 for n in sizes):
        raise ValueError(f"mesh axes {dict(axes)}: sizes must be positive, "
                         "one of them may be -1")
    if -1 in sizes:
        if world % known:
            raise ValueError(f"{world} devices not divisible by "
                             f"{known} (mesh axes {dict(axes)})")
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total > world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, only {world} present")
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} covers {total} "
                         f"of the world's {world} ranks; one process runs "
                         "each rank, so the mesh must cover them all")
    return _device_mesh(dev, np.arange(world).reshape(sizes), names)


def local_mesh(device: DeviceLike = None):
    """The mesh over every rank on the data axis (the common one-rank
    case)."""
    return make_mesh(MeshConfig(), device=device)


def multihost_device_grid(devices: Sequence, num_hosts: int,
                          model: int = 1) -> np.ndarray:
    """Arrange a flat global device list into a (dcn_data, data, model)
    grid.

    Pure layout logic (testable on fake lists): ranks arrive host-major
    (torchrun numbers one host's ranks consecutively), so axis 0 (one entry
    per host) crosses hosts while axes 1-2 stay inside each host.
    ``model`` must divide the per-host count -- TP collectives never cross
    hosts."""
    devs = list(devices)
    if len(devs) % num_hosts:
        raise ValueError(f"{len(devs)} devices not divisible by "
                         f"{num_hosts} hosts")
    per_host = len(devs) // num_hosts
    if per_host % model:
        raise ValueError(f"model={model} does not divide per-host device "
                         f"count {per_host}; TP must stay inside one host's "
                         f"ICI domain")
    return np.array(devs).reshape(num_hosts, per_host // model, model)


def make_multihost_mesh(cfg: Optional[MeshConfig] = None,
                        devices: Optional[Sequence[int]] = None,
                        num_hosts: Optional[int] = None, *,
                        device: DeviceLike = None):
    """(dcn_data, data, model) mesh over all ranks. Batches shard over BOTH
    data axes (``batch_group``) and parameters over 'model'. ``num_hosts``
    defaults to the world size over torchrun's ``LOCAL_WORLD_SIZE``."""
    cfg = cfg or MeshConfig()
    dev = resolve_device(device)
    world = _ensure_world(dev)
    devs = list(devices if devices is not None else range(world))
    if num_hosts is None:
        num_hosts = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE",
                                                       world)))
    grid = multihost_device_grid(devs, num_hosts, max(1, cfg.model))
    if grid.size != world:
        raise ValueError(f"multi-host mesh covers {grid.size} of the "
                         f"world's {world} ranks")
    mesh = _device_mesh(dev, grid, ("dcn_data",) + tuple(cfg.axis_names))
    # the flattened (dcn_data, data) group of every model coordinate; every
    # rank creates every group, in the same order
    me = dist.get_rank()
    for m in range(grid.shape[-1]):
        ranks = [int(r) for r in grid[..., m].reshape(-1)]
        group = dist.new_group(ranks)
        if me in ranks:
            mesh.audax_batch_group = group
    return mesh


# ---------------------------------------------------------------- axes ----
def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` (1 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 for an absent axis)."""
    return (mesh.get_local_rank(name) if name in mesh.mesh_dim_names
            else 0)


def axis_group(mesh, name: str):
    return mesh.get_group(name)


#: the axes a batch never shards over: TP's, SP's and PP's
_NOT_BATCH = ("model", "seq", "stage")


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes a batch shards over: every axis but 'model', 'seq' and
    'stage'."""
    return tuple(n for n in mesh.mesh_dim_names if n not in _NOT_BATCH)


def batch_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in batch_axes(mesh))


def batch_rank(mesh) -> int:
    """This rank's block of a batch: its row-major coordinate over the
    batch axes."""
    r = 0
    for a in batch_axes(mesh):
        r = r * axis_size(mesh, a) + axis_rank(mesh, a)
    return r


def batch_group(mesh):
    """The process group over the batch axes (all of them flattened; None
    when the mesh has none)."""
    axes = batch_axes(mesh)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh.audax_batch_group


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    return getattr(mesh, "audax_device", torch.device(mesh.device_type))


# ------------------------------------------------------------ context ----
def current_mesh():
    """The mesh made current by ``use_mesh`` (None outside one)."""
    return _CURRENT.get()


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current for the model code's collectives (None: no
    mesh)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


# ----------------------------------------------------------- batches ----
def data_sharding(mesh, ndim: int = 1) -> P:
    """Shard axis 0 (batch) over 'data'; replicate the rest."""
    return P("data", *([None] * (ndim - 1)))


def replicated(mesh) -> P:
    return P()


def block_of(x: torch.Tensor, n: int, r: int, dim: int = 0) -> torch.Tensor:
    """Block ``r`` of ``n`` equal blocks of ``x`` along ``dim`` (a view)."""
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(mesh, batch, device: DeviceLike = None):
    """This rank's block of a tree (dict / list / tuple) of [B, ...] arrays
    or tensors, batch-sharded over the batch axes: B is padded up to a
    multiple of their size by repeating row 0 (unmasked: padding rows are
    the caller's to mask, as in JAX), then rank r keeps rows
    [r B/n, (r + 1) B/n). Tensors land on ``device`` (default the mesh's)."""
    n = batch_size(mesh)
    r = batch_rank(mesh)
    dev = mesh_device(mesh) if device is None else torch.device(device)

    def put(x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        b = t.shape[0]
        if b % n:
            pad = pad_to_multiple(b, n) - b
            t = torch.cat([t] + [t[:1]] * pad, dim=0)
        rows = t.shape[0] // n
        return t[r * rows: (r + 1) * rows].to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return put(node)

    return walk(batch)
