"""Device meshes over ``torch.distributed``: one process per device.

The port of ``mcpilco_tpu/parallel/mesh.py``.  JAX runs one controller and
lets XLA insert the collectives from sharding constraints; here every
device has a process of its own (a rank), which binds ``cuda:{rank}`` (or
the CPU, when the caller asks for it), and the few collectives are explicit:

- **particles** (axis ``"p"``): each rank rolls out its slice of the P
  particles, drawn on the full logical shape from the same keys and sliced
  (:func:`shard_particles`); the cost pieces and the policy gradient are
  summed over ``"p"`` once per optimizer iteration
  (``models/costs.expected_cost``, ``PolicyOptimizer._body``);
- **seeds** (axis ``"s"``): each seed group trains its own seeds; the farm's
  results are gathered at the end (``parallel/multiseed.SeedFarm``);
- **restarts** (axis ``"r"``): each rank runs its share of the restart
  lanes; one all-gather of the lanes' best costs picks the winner, whose
  result is broadcast (``PolicyOptimizer.optimize``).

Replicated state (GP parameters, the posterior, the policy parameters at
the start of a call) is made identical by :func:`replicate`, a broadcast
from the group's first rank, so that ranks cannot drift by an ulp.

The backend is NCCL on the card and gloo on the CPU.  :func:`launch` spawns
the ranks of one machine and returns what each returned.  A mesh spans
every rank of the process group.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PARTICLE_AXIS = "p"
SEED_AXIS = "s"
RESTART_AXIS = "r"

# how long a collective may wait for its peers before the run fails
TIMEOUT_S = 600


def local_device() -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """A named grid of every rank of the process group, row-major: adjacent
    ranks share the leading axes' coordinates (a seed group or a restart
    lane), so the chatty particle collectives stay between neighbours.
    Wraps ``torch.distributed.device_mesh.init_device_mesh``."""

    def __init__(self, shape: Dict[str, int]):
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs a process group: run under parallel.mesh.launch "
                               "or call torch.distributed.init_process_group first")
        size = 1
        for n in shape.values():
            size *= int(n)
        if size != dist.get_world_size():
            raise ValueError(f"a mesh of shape {dict(shape)} ({size} ranks) must span the "
                             f"process group's {dist.get_world_size()} ranks")
        self.device = local_device()
        self.axis_names = tuple(shape)
        self.shape = {k: int(v) for k, v in shape.items()}
        self.device_mesh = init_device_mesh(self.device.type, tuple(self.shape.values()),
                                            mesh_dim_names=self.axis_names)

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device})"

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axes: Optional[Sequence[str]] = None):
        """The process group of the ranks that share every coordinate but
        those on ``axes`` (one axis name or several; None: the whole mesh)."""
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(self.axis_names if axes is None else axes)
        if set(axes) == set(self.axis_names):
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        raise ValueError(f"no group over {axes} of a mesh with axes {self.axis_names}")

    def replica_axes(self) -> tuple:
        """The axes over which one optimization's replicated state (GP
        parameters, posterior) is shared: every axis but the seed axis."""
        return tuple(a for a in self.axis_names if a != SEED_AXIS)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1D particle mesh over ``n_devices`` ranks (default: all of them)."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return Mesh({PARTICLE_AXIS: n})


def make_seed_particle_mesh(n_seed_groups: int, n_particle_shards: int) -> Mesh:
    """2D mesh: ``"s"`` shards whole seeds (no traffic between groups until
    the farm's results are gathered), ``"p"`` each seed's particles."""
    return Mesh({SEED_AXIS: n_seed_groups, PARTICLE_AXIS: n_particle_shards})


def make_restart_particle_mesh(n_restart_shards: int, n_particle_shards: int) -> Mesh:
    """2D mesh: ``"r"`` shards the restart lanes (independent until the
    winner is picked), ``"p"`` each lane's particles."""
    return Mesh({RESTART_AXIS: n_restart_shards, PARTICLE_AXIS: n_particle_shards})


def seed_axis(mesh: Mesh) -> str:
    """The axis that shards the seed farm: ``"s"`` on a 2D seed x particle
    mesh, else the mesh's first axis (a 1D farm mesh, as the JAX package
    shards seeds over its ``"p"`` axis)."""
    return SEED_AXIS if SEED_AXIS in mesh.axis_names else mesh.axis_names[0]


def _slice(mesh: Mesh, axis: str, x, dim: int):
    n, i = mesh.shape[axis], mesh.index(axis)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows on dim {dim} do not tile the mesh's {n} "
                         f"'{axis}' shards")
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k)


def shard_particles(mesh: Mesh, x, dim: int = 0):
    """This rank's slice of the full logical tensor ``x`` along its particle
    dim ``dim``."""
    return _slice(mesh, PARTICLE_AXIS, x, dim)


def shard_seeds(mesh: Mesh, x, dim: int = 0):
    """This rank's seed group's slice of ``x`` (a tensor, or a sequence of
    seeds) along its seed dim."""
    if isinstance(x, (list, tuple, range)):
        n, i = mesh.shape[seed_axis(mesh)], mesh.index(seed_axis(mesh))
        if len(x) % n:
            raise ValueError(f"{len(x)} seeds do not tile the mesh's {n} seed group(s)")
        k = len(x) // n
        return list(x)[i * k:(i + 1) * k]
    return _slice(mesh, seed_axis(mesh), x, dim)


def shard_restarts(mesh: Mesh, x, dim: int = 0):
    """This rank's restart lanes of ``x`` along its lane dim."""
    return _slice(mesh, RESTART_AXIS, x, dim)


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, v) for v in t))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, v) for v in t)
    return fn(t) if isinstance(t, torch.Tensor) else t


def broadcast(mesh: Mesh, tree, axes=None, src: int = 0):
    """Every tensor of ``tree`` as the rank at coordinate ``src`` of the
    group over ``axes`` holds it (new tensors, on the devices of the
    originals)."""
    group = mesh.group(axes)

    def one(t):
        buf = t.detach().to(mesh.device, copy=True).contiguous()
        dist.broadcast(buf, group=group, group_src=src)
        return buf.to(t.device)

    return _tree_map(one, tree)


def replicate(mesh: Mesh, tree, axes=None):
    """``tree`` made identical over the group of ``axes`` (default: the
    whole mesh), from the group's first rank."""
    return broadcast(mesh, tree, axes, 0)


def psum_(mesh: Mesh, t: torch.Tensor, axes=None) -> torch.Tensor:
    """Sum ``t`` over the group of ``axes`` in place (on ``mesh.device``)."""
    dist.all_reduce(t, group=mesh.group(axes))
    return t


def all_gather(mesh: Mesh, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The group's tensors, in coordinate order, concatenated along ``dim``."""
    group = mesh.group(axes)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_objects(mesh: Mesh, obj, axes) -> list:
    """Every rank's picklable ``obj`` of the group, in coordinate order
    (keep tensors out of it: pickled CUDA tensors keep their device)."""
    group = mesh.group(axes)
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------- launching


def _rank_main(rank: int, fn: Callable, n_ranks: int, device: str, tmp: str, args: tuple):
    if device == "cuda":
        torch.cuda.set_device(rank)
        backend, dev_id = "nccl", torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        backend, dev_id = "gloo", None
    dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
                            world_size=n_ranks, rank=rank, device_id=dev_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Launch:
    """Ranks started by :func:`start`; :meth:`join` waits for them and
    returns what each rank's function returned, in rank order."""

    def __init__(self, fn: Callable, n_ranks: int, device: str, args: tuple):
        import torch.multiprocessing as mp

        if device not in ("cuda", "cpu"):
            raise ValueError(f"device {device!r}: 'cuda' (NCCL) or 'cpu' (gloo)")
        if device == "cuda":
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if visible < n_ranks:
                raise RuntimeError(f"{n_ranks} NCCL ranks need {n_ranks} cards; {visible} "
                                   "visible")
            # every rank is on this machine: NCCL's bootstrap over loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        self.n_ranks = n_ranks
        self._tmp = tempfile.TemporaryDirectory(prefix="mesh_")
        self._ctx = mp.start_processes(_rank_main, args=(fn, n_ranks, device, self._tmp.name,
                                                         tuple(args)),
                                       nprocs=n_ranks, join=False, start_method="spawn")

    def join(self, timeout: Optional[float] = None) -> list:
        """``timeout`` seconds at most (None: until the ranks end; a rank
        that waits on its peers fails after ``TIMEOUT_S``), then the ranks
        are ended and ``TimeoutError`` raised."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not self._ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{self.n_ranks} ranks still running after {timeout} s")
            out = []
            for r in range(self.n_ranks):
                with open(os.path.join(self._tmp.name, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in self._ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
            self._tmp.cleanup()


def start(fn: Callable, n_ranks: int, device: str = "cuda", args: tuple = ()) -> Launch:
    """Spawn ``n_ranks`` processes that each join one process group (NCCL,
    rank r on ``cuda:r``; or gloo on the CPU, one thread each) and run
    ``fn(*args)``.  ``fn`` must be importable (spawn pickles it by
    reference) and return something picklable.  A rank that raises fails
    the launch and ends the others."""
    return Launch(fn, n_ranks, device, args)


def launch(fn: Callable, n_ranks: int, device: str = "cuda", args: tuple = (),
           timeout: Optional[float] = None) -> list:
    """:func:`start`, then wait (``Launch.join``): what each rank returned,
    in rank order."""
    return start(fn, n_ranks, device, args).join(timeout)
