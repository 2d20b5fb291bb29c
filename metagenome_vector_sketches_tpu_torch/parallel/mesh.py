"""The port's device mesh (JAX ``parallel/mesh.py``).

A :class:`Mesh` is an ordered tuple of torch devices, one SLOT each, all of
one type, plus an optional ``torch.distributed`` process group for runs of
several processes (each process holds its own slots; the global mesh is
the processes' slots in process order). A CUDA slot owns a
``torch.cuda.Stream``, so the slots' launches overlap; ``slot(i)`` makes it
current, and a slot's result reaches the device's current stream only
through :meth:`Mesh.handoff` (or :meth:`Mesh.gather_slots`, which hands
off every slot's part).

torch has one CPU device, and a mesh may repeat a device: the CPU tests run
the mesh code on 8 slots of ``cpu`` (as the JAX tests run 8 virtual XLA
devices), and the GPU smoke runs 2 slots of ``cuda:0``. Such a mesh is only
ever built explicitly (``Mesh([...])``); :func:`make_mesh`,
:func:`local_mesh` and :func:`serving_mesh` (and so every command-line
flag) take distinct local devices. Where two slots share a device,
replicating a tensor to both is ``.to(device)``, which returns the tensor
itself: no bytes are doubled.
"""

from __future__ import annotations

import contextlib

import torch

from .._device import local_cards, resolve_device, serving_devices

# the name of the mesh's one axis in the JAX package
DATA_AXIS = "data"


class Mesh:
    """Ordered device slots of this process (``devices``) and the process
    group that joins them to other processes' slots (``group``; None: this
    process alone)."""

    def __init__(self, devices, group=None):
        devs = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            devs.append(dev)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {devs}")
        self.devices = tuple(devs)
        self.group = group
        self.streams = tuple(torch.cuda.Stream(device=d)
                             if d.type == "cuda" else None for d in devs)

    @property
    def size(self) -> int:
        """Slots of this process."""
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The first slot's device: where gathered results land."""
        return self.devices[0]

    @property
    def device_type(self) -> str:
        return self.lead.type

    @property
    def process_count(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def process_index(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def global_size(self) -> int:
        """Slots of all processes (each process holds ``size``)."""
        return self.size * self.process_count

    @property
    def key(self) -> tuple:
        """Hashable identity for caches: the slots and the process count."""
        return tuple(str(d) for d in self.devices), self.process_count

    def distinct_devices(self) -> list:
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        procs = f", processes={self.process_count}" if self.group else ""
        return f"Mesh({[str(d) for d in self.devices]}{procs})"

    @contextlib.contextmanager
    def slot(self, i: int):
        """Run the block on slot i: its stream becomes current (after it
        waits for the work already queued on its device's current stream,
        which made the slot's inputs)."""
        s = self.streams[i]
        if s is None:
            yield
            return
        s.wait_stream(torch.cuda.current_stream(s.device))
        with torch.cuda.stream(s):
            yield

    def handoff(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Slot i's result ``t`` (made on its stream), made safe to use on
        its device's current stream: that stream waits for the slot's, and
        the caching allocator keeps t's memory until it is done with it."""
        s = self.streams[i]
        if s is not None:
            cur = torch.cuda.current_stream(s.device)
            cur.wait_stream(s)
            t.record_stream(cur)
        return t

    def gather_slots(self, parts, dim: int = 0) -> torch.Tensor:
        """One tensor per slot (slot i's result, on its device) -> their
        concatenation along ``dim`` on the lead device, in slot order, on
        the current stream (each part handed off first)."""
        return torch.cat([self.handoff(i, p).to(self.lead)
                          for i, p in enumerate(parts)], dim=dim)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Concatenate every process's ``t`` (same shape on each) along
        ``dim`` in process order; ``t`` itself without a process group (a
        group of one process still runs the collective). The result lies
        on t's device."""
        if self.group is None:
            return t
        import torch.distributed as dist
        nccl = dist.get_backend(self.group) == "nccl"
        buf = t.contiguous()
        if nccl and not buf.is_cuda:
            buf = buf.to(self.lead if self.lead.type == "cuda"
                         else local_cards()[0])
        elif not nccl and buf.device.type != "cpu":
            buf = buf.cpu()                       # gloo gathers host tensors
        out = [torch.empty_like(buf) for _ in range(self.process_count)]
        dist.all_gather(out, buf, group=self.group)
        return torch.cat(out, dim=dim).to(t.device)


def local_devices(device) -> list:
    """This process's devices of ``device``'s type: its cards for CUDA
    (the one ``multihost.initialize`` bound it to, else every visible
    card), the one CPU device for the CPU."""
    dev = resolve_device(device)
    return local_cards() if dev.type == "cuda" else [torch.device("cpu")]


def make_mesh(n_devices: int | None = None, *, device) -> Mesh:
    """1-D mesh over the first n_devices local devices of ``device``'s
    type (all of them when None)."""
    devs = local_devices(device)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(devs)


def local_mesh(*, device, group=None) -> Mesh:
    """1-D mesh over THIS process's devices (the engine mesh of one shard
    job; ``group`` joins it to the other processes)."""
    return Mesh(local_devices(device), group=group)


def serving_mesh(mesh_devices: int, *, device) -> Mesh | None:
    """The command-line tools' --mesh_devices over LOCAL devices (JAX
    ``serving_mesh``): 1 = one device (None); 0 = every local device; n > 1
    = the first n. Raises ValueError for n < 0 and for more devices than
    this process has (:func:`_device.serving_devices`)."""
    dev = resolve_device(device)
    n = serving_devices(mesh_devices, dev)
    return Mesh(local_devices(dev)[:n]) if n > 1 else None


def row_sharding(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> list:
    """``x`` split along ``dim`` into one contiguous block per slot, each on
    its slot's device (JAX's row sharding; the size must divide evenly)."""
    if x.shape[dim] % mesh.size:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {mesh.size} slots")
    return [b.to(d).contiguous()
            for b, d in zip(torch.chunk(x, mesh.size, dim=dim), mesh.devices)]


def replicated(mesh: Mesh, x: torch.Tensor) -> tuple:
    """``x`` on every slot's device, one entry per slot (x itself where a
    slot's device is x's: no copy)."""
    return tuple(x.to(d) for d in mesh.devices)
