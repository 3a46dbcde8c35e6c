"""Process meshes for tiled dense flow, over ``torch.distributed``.

Counterpart of ``tpuflow.sharding.mesh``. The reference lays a
("batch", "ty", "tx") grid over JAX devices and reaches its neighbours by
XLA collectives; here each tile is one process (one rank), and the
collectives are ``torch.distributed``'s, outside any kernel: NCCL between
cards, gloo between processes that share a card or run on the CPU.

Mesh axes:
    "batch" - data parallel over independent frame pairs
    "ty"    - image-row tiling
    "tx"    - image-column tiling

Ranks map to ``(b, iy, ix)`` row-major, as the reference's
``reshape(batch, ty, tx)`` maps devices. The transport is the group's
own: under NCCL the strips and sums stay on the card; gloo's
point-to-point operations take CPU tensors only, so under gloo every
collective here goes through host memory (``through_host``). There is
no switch from one backend to the other on failure: the caller picks it.

Teardown order. A CUDA graph that captured NCCL work on a mesh's groups
(``flow.TiledGraphedStream``, a mesh-tiled VO front end's graphed step)
holds that group's communicator: while such a graph is referenced,
``dist.destroy_process_group`` never returns on any rank (four cards,
torch 2.11: ``python -m tpuflow_torch.ablation.teardown``'s ``live``
scenario; with every graph freed it returns, one mesh or three). A
reference is easily kept (a session, a loop variable), so every rank
releases each mesh it made, in the same order on every rank, and then
destroys the world::

    release_mesh(mesh)          # the mesh's graphs freed, then its groups
    dist.destroy_process_group()

``release_mesh`` closes every graph captured over the mesh (each holder
registered itself with ``hold_graph``; a closed stream raises on its next
step), waits for the card, and destroys the mesh's own process groups, so
the groups of several ``make_flow_mesh`` calls do not outlive their use.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import weakref
from datetime import timedelta

import torch
import torch.distributed as dist

AXES = ("batch", "ty", "tx")
# Every process group of this package waits at most this long for a peer,
# so a rank that fails or hangs fails its peers instead of stalling them.
TIMEOUT = timedelta(seconds=120)


@dataclasses.dataclass
class Counters:
    """Traffic of the tiled paths on this rank since the last reset."""

    halo_exchanges: int = 0  # exchange_halo_2d / _exchange_axis calls
    halo_bytes: int = 0      # bytes of border strips this rank sent
    level_gathers: int = 0   # pyramid levels gathered whole (tiled_pyramidal)
    gather_bytes: int = 0    # bytes this rank contributed to all-gathers
    all_reduces: int = 0     # sums reduced over a group
    convergence_reads: int = 0  # early-exit flags read to the host (the parity loop)
    # Rounds run at each level by the latest device-controlled tiled solve:
    # an int32 (local batch, levels) tensor on the mesh's device, written
    # by the kernels (never read here); None after a host-steered solve.
    level_rounds: torch.Tensor | None = None

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, None if f.name == "level_rounds" else 0)

    def traffic(self) -> dict[str, int]:
        """The counts, without ``level_rounds``."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "level_rounds"}


counters = Counters()


def through_host(group, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through host memory to cross ``group``: gloo moves
    CPU tensors only."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (the world when None); returns the sum on
    ``t``'s device. Every rank gets the same bits, so a decision taken
    from the result is the same on every rank. Under NCCL the sum stays
    on the card and nothing is read to the host, so a CUDA graph can
    capture it."""
    counters.all_reduces += 1
    buf = t.detach().to("cpu", copy=True) if through_host(group, t) else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes) in group-rank order, on ``t``'s
    device. Under NCCL into one tensor on the card (views of it come back),
    which a CUDA graph can capture."""
    staged = through_host(group, t)
    src = (t.to("cpu") if staged else t).contiguous()
    n = dist.get_world_size(group)
    counters.gather_bytes += src.numel() * src.element_size()
    if src.is_cuda:
        out = torch.empty((n, *src.shape), dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return list(out.unbind(0))
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if staged else out


def assemble(tiles: list[torch.Tensor], ty: int, tx: int) -> torch.Tensor:
    """The whole (..., H, W) image from its ``ty * tx`` tiles, row-major."""
    rows = [torch.cat(tiles[iy * tx:(iy + 1) * tx], dim=-1) for iy in range(ty)]
    return torch.cat(rows, dim=-2)


@dataclasses.dataclass(frozen=True, eq=False)
class FlowMesh:
    """A ("batch", "ty", "tx") grid of ranks, one tile each.

    ``group`` holds every rank of the mesh (the final gathers);
    ``spatial`` the ranks of this rank's batch slice (halo strips,
    convergence sums and level gathers), or None where this rank lies
    outside the mesh (a world larger than ``batch * ty * tx``)."""

    batch: int
    ty: int
    tx: int
    ranks: tuple[int, ...]  # global ranks, row-major over (batch, ty, tx)
    rank: int               # this process's global rank
    device: torch.device
    group: object
    spatial: object

    @property
    def shape(self) -> dict[str, int]:
        return {"batch": self.batch, "ty": self.ty, "tx": self.tx}

    @property
    def coords(self) -> tuple[int, int, int]:
        """This rank's ``(b, iy, ix)``; raises outside the mesh."""
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} lies outside the {self.shape} mesh")
        i = self.ranks.index(self.rank)
        return i // (self.ty * self.tx), (i // self.tx) % self.ty, i % self.tx

    def rank_at(self, b: int, iy: int, ix: int) -> int:
        return self.ranks[(b * self.ty + iy) * self.tx + ix]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[AXES.index(axis)]

    def gather_spatial(self, tile: torch.Tensor) -> torch.Tensor:
        """The whole (..., H, W) image from every tile of this batch slice."""
        return assemble(all_gather(tile, self.spatial), self.ty, self.tx)


def _default_device(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_flow_mesh puts each rank on a CUDA device and none is available; "
            "pass device='cpu' to run the mesh on the CPU (gloo)"
        )
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def check_one_rank_per_card(entries) -> None:
    """NCCL refuses two ranks on one card ("Duplicate GPU detected"): raise
    a clear error first. ``entries`` holds each rank's (host, device index)."""
    seen: dict = {}
    for rank, key in enumerate(entries):
        if key in seen:
            raise ValueError(
                f"ranks {seen[key]} and {rank} share CUDA device {key[1]} on {key[0]}: "
                "NCCL takes one rank per card; run several ranks on one card over gloo"
            )
        seen[key] = rank


def make_flow_mesh(
    batch: int = 1,
    ty: int = 1,
    tx: int = 1,
    *,
    device: torch.device | str | None = None,
) -> FlowMesh:
    """Build a ("batch", "ty", "tx") mesh from the first ``batch * ty * tx``
    ranks of the world, row-major.

    Every rank of the world must call this, with the same arguments: it
    creates the mesh's process groups (all ranks call ``dist.new_group``
    for every sub-group, in one order) and runs one collective on each
    group the rank belongs to, so that NCCL's communicators exist before
    the first halo exchange; under NCCL it also runs one halo exchange, so
    that every neighbour pair's point-to-point communicator exists before
    a CUDA graph captures a send. ``device`` defaults to the card
    ``cuda:(LOCAL_RANK % device_count)``; without a card pass ``"cpu"``.
    Raises ``ValueError`` when the world has fewer ranks than the mesh, or
    when an NCCL mesh puts two ranks on one card."""
    world = list(range(dist.get_world_size()))
    n = batch * ty * tx
    if len(world) < n:
        raise ValueError(f"mesh ({batch}x{ty}x{tx}) needs {n} ranks, have {len(world)}")
    rank = dist.get_rank()
    dev = _default_device(rank) if device is None else torch.device(device)
    if dist.get_backend() == "nccl":
        if dev.type != "cuda":
            raise ValueError("an NCCL mesh needs CUDA devices; use gloo on the CPU")
        torch.cuda.set_device(dev)
        side = dist.new_group(world, backend="gloo", timeout=TIMEOUT)
        entries = [None] * len(world)
        dist.all_gather_object(entries, (socket.gethostname(), dev.index), group=side)
        dist.destroy_process_group(side)
        check_one_rank_per_card(entries[:n])
    ranks = tuple(world[:n])
    mesh_group = dist.new_group(list(ranks), timeout=TIMEOUT)
    spatial = None
    for b in range(batch):
        g = dist.new_group(list(ranks[b * ty * tx:(b + 1) * ty * tx]), timeout=TIMEOUT)
        if rank in ranks[b * ty * tx:(b + 1) * ty * tx]:
            spatial = g
    mesh = FlowMesh(batch, ty, tx, ranks, rank, dev, mesh_group, spatial)
    if rank in ranks:
        warm = torch.zeros(1, device=dev)
        for g in (mesh_group, spatial):
            all_reduce_sum(warm, g)
        if dist.get_backend() == "nccl":
            # ProcessGroupNCCL makes a pair's communicator at its first send.
            from tpuflow_torch.sharding.halo import exchange_halo_2d

            exchange_halo_2d(torch.zeros((2, 2), device=dev), 1, mesh, boundary="zero")
    return mesh


# Objects that hold a CUDA graph captured over a mesh's groups, by mesh:
# each has ``close()``, which frees its graph.
_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
# Meshes whose groups ``release_mesh`` has destroyed.
_RELEASED: weakref.WeakSet = weakref.WeakSet()


def hold_graph(mesh: FlowMesh, holder) -> None:
    """Record that ``holder`` keeps a CUDA graph captured over ``mesh``'s
    groups: ``release_mesh`` calls its ``close()`` before the groups go."""
    if mesh in _RELEASED:
        raise ValueError("this mesh was released: make a new one")
    _GRAPHS.setdefault(mesh, weakref.WeakSet()).add(holder)


def release_mesh(mesh: FlowMesh) -> None:
    """Free every CUDA graph captured over ``mesh``, then destroy the
    mesh's process groups (see the module's teardown order). Every rank of
    the world calls it for the same meshes in the same order; a second
    call does nothing. The mesh takes no more collectives afterwards."""
    if mesh in _RELEASED:
        return
    for holder in list(_GRAPHS.pop(mesh, ())):
        holder.close()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    _RELEASED.add(mesh)
    if not dist.is_initialized() or mesh.rank not in mesh.ranks:
        return
    for group in (mesh.spatial, mesh.group):
        dist.destroy_process_group(group)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "nccl",
) -> bool:
    """Join the process group: call once per process before any collective.

    ``coordinator_address`` is ``host:port`` (TCP rendezvous), a URL
    (``tcp://...`` or ``file://...``), or None for the ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) that
    launchers such as ``torchrun`` set. Under NCCL the process first takes
    the card ``LOCAL_RANK % device_count`` (or ``process_id`` where no
    ``LOCAL_RANK`` is set). Returns True when this call joined, False when a
    process group already exists (idempotent re-entry). Any other failure
    raises: a broken coordinator never falls back to a single process."""
    if dist.is_initialized():
        return False
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=TIMEOUT,
    )
    return True
