"""The ``('t', 's')`` mesh of the port — counterpart of
``pods_digital_filter_tpu/parallel/mesh.py`` on ``torch.distributed``.

JAX drives a mesh of local devices from one process.  The port runs one
process (a rank) per mesh position instead: rank ``r`` of a
``shard_time x shard_space`` job sits at ``(ti, si) = divmod(r, shard_space)``
(the JAX device array's row-major order) and holds plain local tensors; the
collectives are explicit calls on the ``'t'`` and ``'s'`` sub-groups
(:class:`Mesh`).

* ``'t'`` — time blocks (the reference's ``DivideByNP`` snapshot partition,
  nsigproclib:485-504);
* ``'s'`` — inlet-plane z tiles.

The ranks are started by :func:`launch_local` (what the CLI does for
``--shard_time``/``--shard_space`` on one host), or join a job of their own
through :func:`init_distributed` (``--multihost``, or ``torchrun``'s
environment).

**Backend.**  The default process group is gloo (objects and barriers).
The mesh's groups use NCCL when the device is CUDA and no two ranks share a
card, else gloo: on the CPU, or several ranks on one card, where NCCL
refuses to run ("Duplicate GPU detected").  Gloo takes no CUDA tensor in
``all_gather`` or ``send``/``recv``, so with gloo every CUDA tensor is
staged through a host copy inside the collective methods.  The choice
follows from the ranks' ``(host, device)`` layout alone.

**Spans.**  Every collective is a span of :mod:`..utils.timing` named
``mesh.<method>`` (``mesh.exchange_t`` for :meth:`Mesh.exchange` along
``'t'``; ``mesh.broadcast`` for both broadcasts) whose ``_bytes`` are the
bytes of its result on this rank.  While a profiler records, each
synchronizes the rank's card on entry and exit, so that its seconds are
the transfer's and not the enqueue's.

JAX's ``hard_sync`` is :func:`..device.synchronize`; its
``snapshot_sharding``/``field_sharding`` are the layout tuples
:data:`SNAPSHOT` and :data:`FIELD`.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from pods_digital_filter_tpu_torch.device import resolve_device
from pods_digital_filter_tpu_torch.utils import timing

#: seconds a collective (and the rendezvous) waits for a peer before it
#: raises: a rank that dies ends the job within this time
TIMEOUT_S = 300

#: how the ranks of a sharded run are started (for error messages)
LAUNCHERS = ("start the ranks with the CLI (--shard_time/--shard_space "
             "launch them on this host), parallel.mesh.launch_local, "
             "--multihost, or torchrun")

#: layouts: which mesh axis splits each dimension of a local tensor
FIELD = (None, "t", None, "s")     # fields (C, Ns, jma, kma)
SNAPSHOT = ("s", "t")              # packed snapshots (3*Np, Ns)
PLANE = (None, None, "s")          # mean fields (C, jma, kma)
MODES = (None, None, None, "s")    # spatial mode fields (C, m, jma, kma)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``shard_time x shard_space`` mesh, its
    device, the backend of its groups and the collectives along an axis.

    Every rank of the group must make the same collective calls in the same
    order, and only from the main thread (checked): a collective issued by a
    worker thread beside the main thread's would interleave with them."""

    shard_time: int
    shard_space: int
    rank: int
    device: torch.device
    backend: str                    # "nccl", "gloo", or "none" (one rank)
    devices: tuple                  # "host:device" of every rank
    groups: dict = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return {"t": self.shard_time, "s": self.shard_space}

    @property
    def ti(self) -> int:
        return self.rank // self.shard_space

    @property
    def si(self) -> int:
        return self.rank % self.shard_space

    @property
    def lead(self) -> bool:
        """Rank 0: the rank that solves the eigen half and writes files."""
        return self.rank == 0

    def index(self, axis: str) -> int:
        return self.ti if axis == "t" else self.si

    def size(self, axis: str) -> int:
        return self.shape[axis]

    # --- collectives ------------------------------------------------------

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        _check_main_thread()
        if self.backend == "gloo" and x.device.type != "cpu":
            x = x.cpu()
        return x.detach().contiguous()

    def _span(self, what: str, nbytes: int):
        return timing.span("mesh." + what, nbytes, self.device)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over ``axis`` (may reuse ``x``'s storage)."""
        if self.size(axis) == 1:
            return x
        w = self._wire(x)
        with self._span("all_reduce", _nbytes(w)):
            dist.all_reduce(w, group=self.groups[axis])
        return w.to(x.device)

    def _stacked(self, x: torch.Tensor, axis: str, what: str) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` in one ``(size(axis), *x.shape)``
        buffer on the wire's device (NCCL gathers into it; gloo fills its
        slices)."""
        w = self._wire(x)
        out = torch.empty((self.size(axis),) + tuple(w.shape), dtype=w.dtype,
                          device=w.device)
        with self._span(what, _nbytes(out)):
            if self.backend == "nccl":
                dist.all_gather_into_tensor(out, w, group=self.groups[axis])
            else:
                dist.all_gather(list(out.unbind(0)), w,
                                group=self.groups[axis])
        return out

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in mesh
        order (every rank's ``x`` has the same shape)."""
        if self.size(axis) == 1:
            return x
        out = self._stacked(x, axis, "all_gather")
        return torch.cat(out.unbind(0), dim=dim).to(x.device)

    def exchange(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` stacked in mesh order ->
        ``(size(axis), *x.shape)`` on ``x``'s device, with no
        concatenation."""
        if self.size(axis) == 1:
            return x[None]
        return self._stacked(x, axis, "exchange_" + axis).to(x.device)

    def shift_s(self, to_right: torch.Tensor, to_left: torch.Tensor):
        """Neighbour exchange along ``'s'`` (not periodic): ``to_right``
        goes to tile ``si + 1``, ``to_left`` to tile ``si - 1``.  Returns
        ``(from_left, from_right)``, None at the edges."""
        si, n = self.si, self.shard_space
        ops, got = [], {}
        for peer_si, send in ((si - 1, to_left), (si + 1, to_right)):
            if 0 <= peer_si < n:
                peer = self.ti * n + peer_si
                w = self._wire(send)
                got[peer_si] = torch.empty_like(w)
                ops += [dist.P2POp(dist.isend, w, peer, self.groups["s"]),
                        dist.P2POp(dist.irecv, got[peer_si], peer,
                                   self.groups["s"])]
        if ops:
            with self._span("shift_s", sum(_nbytes(g) for g in got.values())):
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        back = lambda k: None if k not in got else got[k].to(to_right.device)
        return back(si - 1), back(si + 1)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank, on the device of each rank's ``x``:
        every rank passes a tensor of rank 0's shape and dtype.  It goes
        over the job's default group (gloo), staged through the host: meant
        for small tensors (counts, a spectrum, a few columns)."""
        _check_main_thread()
        if self.backend == "none":
            return x
        w = x.detach().cpu().contiguous()
        with self._span("broadcast", _nbytes(w)):
            dist.broadcast(w, src=0)
        return w.to(x.device)

    def broadcast_object(self, obj):
        """Rank 0's picklable ``obj`` on every rank."""
        _check_main_thread()
        if self.backend == "none":
            return obj
        box = [obj if self.lead else None]
        with self._span("broadcast", 0):
            dist.broadcast_object_list(box, src=0)
        if timing.recording():
            timing.count("mesh.broadcast_bytes", len(pickle.dumps(box[0])))
        return box[0]

    def barrier(self) -> None:
        _check_main_thread()
        if self.backend != "none":
            dist.barrier()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _check_main_thread() -> None:
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError(
            "a mesh collective was called from a worker thread; collectives "
            "run on the main thread only, in the same order on every rank")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     init_method: str | None = None) -> None:
    """Join the job's default (gloo) process group — the counterpart of
    ``jax.distributed.initialize``.  ``coordinator_address`` ``HOST:PORT``
    (rank 0 listens there) with ``num_processes`` and ``process_id``, or an
    explicit ``init_method`` (``file://...``) with both counts; without
    either, ``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``).  A no-op when the group exists."""
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs --num_processes "
                             "and --process_id")
        world, rank = num_processes, process_id
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                       "WORLD_SIZE")):
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        raise ValueError(
            "--multihost needs --coordinator HOST:PORT, --num_processes and "
            "--process_id, or torchrun's environment (MASTER_ADDR, "
            "MASTER_PORT, RANK, WORLD_SIZE)")
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a job of {world}")
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _rank_device(requested: torch.device, local_rank: int) -> torch.device:
    """``cuda`` without an index spreads the host's ranks over its cards
    (``cuda:{local_rank mod count}``); ``cuda:N`` pins every rank to card
    N; ``cpu`` stays."""
    if requested.type == "cuda" and requested.index is None \
            and torch.cuda.is_available():
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return requested


#: (shard_time, shard_space, device) -> (the process group it was made
#: in, the mesh): a new process group makes new meshes
_MESHES: dict = {}


def make_mesh(shard_time: int = 1, shard_space: int = 1,
              device="cpu") -> Mesh:
    """This rank's :class:`Mesh` over the job's process group, whose world
    size must be ``shard_time * shard_space`` (a 1 x 1 mesh needs no
    group).  Collective: every rank calls it, with the same arguments.  The
    rank's device is chosen here, before its first CUDA call; the mesh is
    made once per process group and arguments."""
    n = shard_time * shard_space
    if shard_time < 1 or shard_space < 1:
        raise ValueError("shard_time/shard_space must be >= 1")
    requested = torch.device(device)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh {shard_time}x{shard_space} needs {n} ranks and no "
                f"process group is initialised: {LAUNCHERS}")
        dev = resolve_device(requested)
        return Mesh(1, 1, 0, dev, "none", (f"{socket.gethostname()}:{dev}",))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"mesh {shard_time}x{shard_space} needs {n} ranks, the process "
            f"group has {world}: {LAUNCHERS}")
    key = (shard_time, shard_space, str(requested))
    world_group, mesh = _MESHES.get(key, (None, None))
    if world_group is dist.group.WORLD:
        return mesh
    rank = dist.get_rank()
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    dev = resolve_device(_rank_device(requested,
                                      hosts[:rank].count(hosts[rank])))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    names = [None] * world
    dist.all_gather_object(names, f"{hosts[rank]}:{dev}")
    backend = ("nccl" if dev.type == "cuda" and len(set(names)) == world
               else "gloo")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    t_groups = [dist.new_group([ti * shard_space + si
                                for ti in range(shard_time)],
                               backend=backend, timeout=timeout)
                for si in range(shard_space)]
    s_groups = [dist.new_group([ti * shard_space + si
                                for si in range(shard_space)],
                               backend=backend, timeout=timeout)
                for ti in range(shard_time)]
    ti, si = divmod(rank, shard_space)
    mesh = Mesh(shard_time, shard_space, rank, dev, backend, tuple(names),
                {"t": t_groups[si], "s": s_groups[ti]})
    _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def global_mesh(shard_time: int = 1, shard_space: int = 0,
                device="cpu") -> Mesh:
    """Mesh over every rank of the job; ``shard_space=0`` means the world
    size over ``shard_time``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shard_space == 0:
        if n % shard_time:
            raise ValueError(f"{n} ranks not divisible by "
                             f"shard_time={shard_time}")
        shard_space = n // shard_time
    return make_mesh(shard_time, shard_space, device)


def put_global(x: np.ndarray, mesh: Mesh, layout, dtype=None) -> torch.Tensor:
    """This rank's shard of a host array that is identical on every rank
    (the multi-process ``Bcast`` analog, nsigproclib_no_mpi.py:315-360):
    each dimension split by ``layout``'s axis is sliced to the rank's
    block, on the rank's device."""
    x = np.asarray(x)
    idx = []
    for d, axis in enumerate(layout):
        if axis is None:
            idx.append(slice(None))
            continue
        n, i = mesh.size(axis), mesh.index(axis)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} ({x.shape[d]}) not divisible "
                             f"by the {axis!r} axis ({n})")
        b = x.shape[d] // n
        idx.append(slice(i * b, (i + 1) * b))
    t = torch.as_tensor(np.ascontiguousarray(x[tuple(idx)]))
    return t.to(device=mesh.device, dtype=dtype or t.dtype)


def to_host(x: torch.Tensor, mesh: Mesh, layout,
            dtype=np.float64) -> np.ndarray:
    """The global array of the local shards ``x`` (split by ``layout``), as
    numpy on every rank — the all-gather that replaces the reference's
    ``MPI_local_to_global_*`` assembly (nsigproclib_no_mpi.py:364-482).
    Collective over every sharded axis."""
    for d, axis in enumerate(layout):
        if axis is not None:
            x = mesh.all_gather(x, axis, d)
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().cpu().numpy().astype(dtype, copy=False)


def _rank_main(rank, world, store_dir, fn, args, threads):
    if threads:
        torch.set_num_threads(threads)
    init_distributed(num_processes=world, process_id=rank,
                     init_method=f"file://{os.path.join(store_dir, 'store')}")
    try:
        out = fn(*args)
        # no rank leaves while another may still talk to it
        dist.barrier()
        if rank == 0:
            path = os.path.join(store_dir, "result.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def launch_local(fn, world: int, args=(), *, deadline_s: float | None = None,
                 threads: int | None = None):
    """Run ``fn(*args)`` in ``world`` ranks on this host and return rank
    0's result.

    The ranks are spawned processes (the ``spawn`` start method, so a
    parent that has touched CUDA is safe) that join a gloo group through a
    ``file://`` store in a fresh temporary directory; ``fn`` must be
    importable by name.  As soon as any rank exits with an error the others
    are terminated and the error is raised here
    (``torch.multiprocessing.ProcessRaisedException`` with the rank's
    traceback, or ``ProcessExitedException``).  ``deadline_s`` bounds the
    whole run (``TimeoutError``); ``threads`` sets each rank's torch thread
    count."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="pods_mesh_") as store_dir:
        ctx = mp.start_processes(
            _rank_main, args=(world, store_dir, fn, tuple(args), threads),
            nprocs=world, join=False, start_method="spawn")
        end = None if deadline_s is None else time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=0.5):
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"{world} ranks still running after {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(timeout=10)
        with open(os.path.join(store_dir, "result.pkl"), "rb") as f:
            return pickle.load(f)
