"""Multi-process runs on ``torch.distributed`` (JAX
``parallel/multihost.py``).

The reference scales across machines by launching one process per
--shard_idx from an HPC job array, with the filesystem as the only
"collective". The port keeps that contract (shard folders stay
independently restartable units) and adds runs of several processes:

- :func:`initialize` starts ``torch.distributed`` from its arguments or the
  environment (NCCL for CUDA devices, gloo on the CPU); a no-op when
  neither asks for a multi-process run.
- :func:`host_shards` maps the reference's shard space onto processes
  (process k computes shards k, k + P, k + 2P, ...: a drop-in for a job
  array).
- :func:`global_mesh` is this process's devices joined to every other
  process's by the default process group; the distributed indexes and
  top-k gather over it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .._device import bind_card, resolve_device
from .mesh import Mesh, local_mesh

# the environment of a multi-process run (torchrun's names): the
# coordinator's address and port, the process count, this process's rank,
# and its rank among the processes of its node (the card it takes there)
ENV_ADDR, ENV_PORT = "MASTER_ADDR", "MASTER_PORT"
ENV_COUNT, ENV_ID = "WORLD_SIZE", "RANK"
ENV_LOCAL = "LOCAL_RANK"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, local_card: int | None = None,
               *, device) -> None:
    """Start ``torch.distributed`` (the default process group) from the
    arguments or the environment: MASTER_ADDR and MASTER_PORT (the
    coordinator_address "host:port"), WORLD_SIZE (num_processes) and RANK
    (process_id). A no-op when neither the arguments nor the environment
    ask for a multi-process run. Every value of the environment is read,
    not just the address. The backend is NCCL for a CUDA ``device``, gloo
    on the CPU.

    On CUDA each process needs cards of its own. ``local_card`` (else
    LOCAL_RANK, as torchrun sets it) binds the process to that one card:
    its meshes hold only it, and it becomes the current device. Without
    either, the process keeps every visible card (CUDA_VISIBLE_DEVICES
    gives each process its own), and the run is refused with ValueError
    when two processes see the same card."""
    addr = coordinator_address
    if addr is None and ENV_ADDR in os.environ:
        addr = f"{os.environ[ENV_ADDR]}:{os.environ.get(ENV_PORT, '29500')}"
    if addr is None and num_processes is None:
        return
    if num_processes is None and ENV_COUNT in os.environ:
        num_processes = int(os.environ[ENV_COUNT])
    if process_id is None and ENV_ID in os.environ:
        process_id = int(os.environ[ENV_ID])
    if addr is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "address, the process count and this process's id "
                         f"(got {addr!r}, {num_processes!r}, "
                         f"{process_id!r})")
    cuda = resolve_device(device).type == "cuda"
    if cuda:
        if local_card is None and ENV_LOCAL in os.environ:
            local_card = int(os.environ[ENV_LOCAL])
        if local_card is not None:
            bind_card(local_card)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{addr}",
                            world_size=num_processes, rank=process_id)
    if cuda and local_card is None:
        _refuse_shared_cards()


def shared_cards(cards_by_process) -> list:
    """The card ids (e.g. UUIDs) that more than one process lists, in the
    order they first appear (``cards_by_process``: one list per
    process)."""
    owner, shared = {}, []
    for p, cards in enumerate(cards_by_process):
        for c in cards:
            if owner.setdefault(c, p) != p and c not in shared:
                shared.append(c)
    return shared


def _refuse_shared_cards() -> None:
    """ValueError (after the process group is torn down) when two processes
    of the run see the same card: NCCL takes one card per process.
    Exchanged over a gloo group, which needs no card."""
    mine = [str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count())]
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, mine, group=dist.new_group(backend="gloo"))
    shared = shared_cards(seen)
    if shared:
        dist.destroy_process_group()
        raise ValueError(f"{len(shared)} card(s) are visible to more than one "
                         "process; give each process its own cards "
                         "(LOCAL_RANK, local_card=, or CUDA_VISIBLE_DEVICES)")


def process_info() -> tuple[int, int]:
    """(process_index, process_count): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shards(num_shards: int) -> list[int]:
    """The shard indices this process is responsible for (strided, as an
    HPC array job of num_shards tasks over the processes)."""
    pid, pcount = process_info()
    return list(range(pid, num_shards, pcount))


def global_mesh(*, device) -> Mesh:
    """This process's devices of ``device``'s type, joined to the other
    processes' by the default process group (this process alone without
    one)."""
    group = dist.group.WORLD if dist.is_available() \
        and dist.is_initialized() else None
    return local_mesh(device=device, group=group)


def compute_pairwise_multihost(db_folder: str, output_folder: str,
                               num_shards: int, mesh: Mesh | None = None,
                               *, device, **kwargs) -> list[str]:
    """Run this process's share of the shard space (call on every
    process); returns the shard folders this process wrote.

    Each shard runs mesh-parallel over ``mesh``, by default THIS process's
    devices (parallel.engine), so P processes with C devices each give
    shard-level scatter (the reference's job-array model) times C-way tile
    parallelism inside every shard. A mesh of one slot is the
    single-device engine."""
    from ..matrix.compute import compute_pairwise_shard
    mesh = local_mesh(device=device) if mesh is None else mesh
    return [compute_pairwise_shard(db_folder, output_folder,
                                   num_shards=num_shards, shard_idx=shard_idx,
                                   mesh=mesh, device=device, **kwargs)
            for shard_idx in host_shards(num_shards)]
