"""Ranks and collectives of the port's sharded paths, on ``torch.distributed``.

Port of ``largesteps_tpu/parallel/distributed.py``.  JAX runs one process
a host and one SPMD program over a device mesh; the port runs one process
a rank, ``dp · sp`` of them, each calling the same entry point with the
same arguments.  Rank ``r`` sits at ``(r // sp, r % sp)`` of the mesh.
This module starts the ranks (:func:`init_distributed`, :func:`launch`),
builds the mesh and its groups (:func:`global_mesh`), and holds one
function for each JAX collective the port needs: ``psum`` is
:func:`all_reduce`, ``all_gather`` :func:`all_gather`, ``ppermute``
:func:`ppermute` (and the row shards' halo swaps
:func:`from_next_row_shard` and :func:`to_next_row_shard`).

Transport is chosen by the backend's name, never by trying:

* ``nccl``: every collective runs on the card's tensors.  One rank a card;
  NCCL refuses two ranks on one device.
* ``gloo``: gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``
  only, and copies them through host memory itself.  Its ``all_gather``
  and point-to-point ops take CPU tensors, so for a CUDA tensor these
  functions copy it to the host, run the op there and copy the result
  back: explicitly, and only to move data; no rank computes on the CPU
  when it was given the card.  This is the transport when ranks share one
  card, and on the CPU.

Host-side decisions (a rebin, a stop) are reduced on a gloo group of all
ranks (:attr:`Mesh.host`), so that they read host scalars without a
device round trip under either backend.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_distributed", "process_index", "process_count",
           "is_coordinator", "sync", "Mesh", "global_mesh", "all_reduce",
           "all_gather", "broadcast", "ppermute", "from_next_row_shard",
           "to_next_row_shard", "host_max", "replicate_global",
           "save_checkpoint_multihost", "launch", "RankFailed"]


def init_distributed(rank: int, world: int, backend: str = "gloo",
                     init_method: str | None = None):
    """Join the process group as ``rank`` of ``world`` (idempotent).
    ``init_method`` is the rendezvous, ``file://<path>`` or
    ``tcp://localhost:<port>``; nothing on the machine names a cluster, so
    the caller names it."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def _gloo(group=None) -> bool:
    return dist.get_backend(group) == "gloo"


class Mesh:
    """The ``(dp, sp)`` grid of ranks.  ``dp_index`` and ``sp_index`` are
    this rank's coordinates; ``sp_ranks`` the global ranks of its mesh row
    (its dp index, every sp index), ``dp_ranks`` those of its column;
    ``sp_group`` and ``dp_group`` their process groups; ``host`` a gloo
    group of every rank for host scalars."""

    def __init__(self, dp: int, sp: int):
        world = dist.get_world_size()
        if dp * sp != world:
            raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} ranks; "
                             f"the process group has {world}")
        self.dp, self.sp = int(dp), int(sp)
        self.rank = dist.get_rank()
        self.dp_index, self.sp_index = divmod(self.rank, self.sp)
        self.backend = dist.get_backend()
        self.sp_ranks = [self.dp_index * sp + s for s in range(sp)]
        self.dp_ranks = [d * sp + self.sp_index for d in range(dp)]
        # every rank creates every group, in one order
        self.sp_group = self.dp_group = None
        for d in range(dp):
            g = dist.new_group([d * sp + s for s in range(sp)])
            if d == self.dp_index:
                self.sp_group = g
        for s in range(sp):
            g = dist.new_group([d * sp + s for d in range(dp)])
            if s == self.sp_index:
                self.dp_group = g
        self.host = _host_group()

    @property
    def size(self) -> int:
        return self.dp * self.sp

    def __repr__(self):
        return (f"Mesh(dp={self.dp}, sp={self.sp}, rank={self.rank}, "
                f"backend={self.backend!r})")


_MESHES: dict = {}


def global_mesh(sp: int = 1) -> Mesh:
    """The ``(world / sp, sp)`` mesh of every rank, built once per shape and
    process group (its groups are collective to create)."""
    world = dist.get_world_size()
    if world % sp:
        raise ValueError(f"sp={sp} does not divide {world} ranks")
    key = (id(dist.group.WORLD), world // sp, sp)
    if key not in _MESHES:
        _MESHES[key] = Mesh(world // sp, sp)
    return _MESHES[key]


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group's ranks (JAX's ``psum``), in place; every rank
    gets the same bits.  Both backends take CUDA tensors here."""
    dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` (equal shapes), in group rank order.  Under gloo a
    CUDA tensor goes through host memory (gloo gathers CPU tensors only)."""
    staged = t.is_cuda and _gloo(group)
    src = t.detach().cpu() if staged else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if staged else out


def ppermute(t: torch.Tensor, pairs) -> torch.Tensor:
    """JAX's ``ppermute``: each (src, dst) pair of global ranks sends src's
    ``t`` to dst.  A rank receives the ``t`` sent to it, zeros where none
    is.  Under gloo a CUDA tensor goes through host memory (gloo's
    point-to-point ops take CPU tensors only)."""
    me = dist.get_rank()
    staged = t.is_cuda and _gloo()
    buf = t.detach().cpu() if staged else t.detach().contiguous()
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, d) for s, d in pairs if s == me]
    ops += [dist.P2POp(dist.irecv, out, s) for s, d in pairs if d == me]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out.to(t.device) if staged else out


def from_next_row_shard(t: torch.Tensor, mesh: Mesh):
    """The next row shard's ``t`` (shard s gets s + 1's): the first rows
    that the antialias kernels read past their last row
    (``pallas_core._shift_up_halo``).  None on the last shard, whose
    neighbour is its own last row."""
    r = mesh.sp_ranks
    got = ppermute(t, [(r[s], r[s - 1]) for s in range(1, mesh.sp)])
    return None if mesh.sp_index == mesh.sp - 1 else got


def to_next_row_shard(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The previous row shard's ``t`` (shard s gets s − 1's), zeros on the
    first shard: the shares of the pairs anchored at a shard's last row,
    which belong to the next shard's row 0
    (``pallas_core._shift_down_ch_halo``)."""
    r = mesh.sp_ranks
    return ppermute(t, [(r[s], r[s + 1]) for s in range(mesh.sp - 1)])


def host_max(values, mesh: Mesh | None) -> list:
    """The largest of each host number over every rank (itself without a
    mesh): one small reduction on the host group, so that every rank takes
    the same decision."""
    if mesh is None:
        return list(values)
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host)
    return t.tolist()


def sync(name: str = "ls_sync", group=None):
    """A barrier over the group's ranks."""
    dist.barrier(group=group)


def replicate_global(tree, src: int = 0):
    """Rank ``src``'s values of a dict, list or tuple of tensors and numpy
    arrays on every rank (all ranks pass the same structure and shapes).
    CUDA tensors are broadcast on the card; host values on the host."""
    def one(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda or dist.get_backend() == "gloo":
                return broadcast(x.clone(), src)
            return broadcast(x.clone(), src, group=_host_group())
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x).copy())
            return broadcast(t, src, group=_host_group()).numpy()
        return x
    if isinstance(tree, dict):
        return {k: replicate_global(v, src) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_global(v, src) for v in tree)
    return one(tree)


_HOST = []


def _host_group():
    """A gloo group of every rank (the default group under gloo)."""
    if dist.get_backend() == "gloo":
        return None
    if not _HOST:
        _HOST.append(dist.new_group(backend="gloo"))
    return _HOST[0]


def save_checkpoint_multihost(path, **kwargs):
    """A checkpoint of a sharded run: rank 0 writes, then every rank waits
    for it.  The state is replicated, so the file is the unsharded format
    and resumes at any world size."""
    from ..driver.checkpoint import save_checkpoint
    if is_coordinator():
        save_checkpoint(path, **kwargs)
    sync("ls_checkpoint", group=_host_group())
    return path


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

class RankFailed(RuntimeError):
    """A rank raised, died or outlived the launch's time limit."""


def _rank_main(fn, rank, world, backend, device, init_method, out_dir, args):
    """One rank: stderr to a file, the process group, ``fn``, its result
    pickled for the launcher."""
    err = open(os.path.join(out_dir, f"rank{rank}.err"), "w")
    os.dup2(err.fileno(), 2)
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        init_distributed(rank, world, backend, init_method)
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        traceback.print_exc()
        err.flush()
        os._exit(1)                    # other ranks may hang: the launcher
    dist.barrier()                      # kills them
    dist.destroy_process_group()


def launch(fn, world: int, backend: str = "gloo", device: str = "cpu",
           init_file: str | None = None, args=(), timeout: float = 120.0):
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method), each a rank of a fresh process group of
    ``backend`` that meets at ``init_file`` (a path that does not exist
    yet; by default one in a new temporary directory).  ``device``:
    ``"cpu"`` (one torch thread a rank) or ``"cuda"`` (rank r on card
    r mod the cards).  Returns the ranks' results in rank order.

    ``fn`` must be importable by the children (a module's top-level
    function).  The ranks are joined within ``timeout`` seconds: a rank
    that raises or dies, or a launch past its time, kills every rank and
    raises :class:`RankFailed` with each rank's standard error."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ls_launch_") as out_dir:
        init_file = init_file or os.path.join(out_dir, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device,
                                   f"file://{init_file}", out_dir, args),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        why = None
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                why = "a rank failed"
                break
            if time.monotonic() > deadline:
                why = f"the ranks ran past {timeout:.0f} s"
                break
            time.sleep(0.02)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if why is None and any(p.exitcode != 0 for p in procs):
            why = "a rank failed"
        if why is not None:
            errs = []
            for r in range(world):
                path = os.path.join(out_dir, f"rank{r}.err")
                text = open(path).read() if os.path.exists(path) else ""
                errs.append(f"--- rank {r} (exit {procs[r].exitcode}) ---\n"
                            f"{text[-4000:]}")
            raise RankFailed(f"launch of {world} ranks: {why}\n"
                             + "\n".join(errs))
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
