"""The device mesh (vec_vad_tpu/parallel/mesh.py) in one process.

JAX runs data parallelism as SPMD: a 1-D `Mesh` over the chips, the batch
sharded over its "data" axis, the parameters replicated, and XLA inserting
the reductions, so a sharded step is the one-device step on the whole
batch. Here a mesh is an ordered tuple of torch devices, one replica of
the model for each entry, driven by one process:

  * the routes whose replicas never talk (calc-flow's pairs, a fleet's
    cameras, a model grid's blocks) split their work over the entries and
    gather the results in mesh order;
  * the training routes (BlockTrainer, FlowTrainer) split each batch over
    the entries, run the forwards (`run_replicas`: one thread an entry,
    so that the replicas reach each BatchNorm together and exchange its
    statistics through `all_reduce`), take ONE backward over the sum of
    the replicas' losses, reduce the gradients onto the first entry, step
    Adam there and copy the parameters back out.

Every reduction is a chain of plain `.to(device)` copies summed in mesh
order (`reduce_to_first`) and copied back (`broadcast_from_first`): it
runs on distinct cards and on a mesh that names one device twice alike
(NCCL and torch.cuda.comm refuse a repeated device), it is
differentiable, and its sums are deterministic. An entry may repeat a
device; each entry still gets its own replica, so the copies and
reductions run there too.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from vec_vad_torch.device import resolve_device


class Mesh:
    """An ordered tuple of devices with the one axis "data"."""

    axis_name = "data"

    def __init__(self, devices: Sequence):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def get_mesh(devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """The mesh over `devices` (names or torch.devices, repeats allowed),
    or by default over every visible card for a bare "cuda", the one card
    of "cuda:k", and the CPU only when the caller asks for it ("cpu").
    There is no fallback from the card to the CPU (device.resolve_device)."""
    if devices is not None:
        return Mesh(devices)
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        return Mesh([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    return Mesh([dev])


def as_mesh(mesh) -> Mesh:
    """A route's `mesh=` argument as a Mesh: a single device (a name or a
    torch.device) is its own one-entry mesh, a sequence of devices a
    Mesh."""
    if isinstance(mesh, (str, torch.device)):
        return Mesh([mesh])
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def pad_to_multiple(
    arrays: Sequence[np.ndarray], multiple: int
) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """Wrap-pad leading dims to a multiple of `multiple`; returns padded
    arrays + a weight mask (1 real, 0 padded). Wrap padding (repeat from the
    start) keeps BatchNorm batch statistics in-distribution, and the mask
    zeroes padded elements out of losses/scores."""
    n = arrays[0].shape[0]
    target = int(np.ceil(max(n, 1) / multiple) * multiple)
    pad = target - n
    idx = np.concatenate([np.arange(n), np.arange(pad) % max(n, 1)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return tuple(a[idx] for a in arrays), mask


def shard_bounds(n: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """(lo, hi) of each entry's share of a leading axis of n rows, in mesh
    order: contiguous, sizes differing by at most one (the first n % size
    entries take one more), as torch.tensor_split cuts."""
    k, r = divmod(n, mesh.size)
    out, lo = [], 0
    for i in range(mesh.size):
        hi = lo + k + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


def shard(x: Optional[torch.Tensor], mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """x's leading axis split over the mesh (shard_bounds), each share on
    its entry's device; None stays None on every entry."""
    if x is None:
        return [None] * mesh.size
    return [x[lo:hi].to(d) for (lo, hi), d in
            zip(shard_bounds(x.shape[0], mesh), mesh.devices)]


def gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The entries' shares concatenated in mesh order on `device`."""
    return torch.cat([p.to(device) for p in parts])


def reduce_to_first(tensors: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum of one tensor an entry, on the first entry's device, added
    in mesh order (differentiable: each term is a `.to` copy)."""
    d0 = mesh.devices[0]
    total = tensors[0].to(d0)
    for t in tensors[1:]:
        total = total + t.to(d0)
    return total


def broadcast_from_first(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """`t` (on the first entry) copied to every entry's device, in mesh
    order (differentiable)."""
    return [t.to(d) for d in mesh.devices]


def replicate(module: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One replica of `module` an entry: `module` itself for the first
    (it must live on the first entry's device) and a deep copy moved to
    each other entry's device, a copy of its own even where an entry
    repeats a device."""
    return [module] + [copy.deepcopy(module).to(d) for d in mesh.devices[1:]]


@torch.no_grad()
def copy_from_first(replicas: Sequence[nn.Module]) -> None:
    """Every replica's parameters and buffers overwritten by the first's
    (copies across devices); nothing to do for one replica."""
    if len(replicas) < 2:
        return
    src = replicas[0].state_dict()
    for rep in replicas[1:]:
        for k, v in rep.state_dict().items():
            v.copy_(src[k])


@torch.no_grad()
def reduce_grads_to_first(replicas: Sequence[nn.Module], mesh: Mesh) -> None:
    """Each parameter's gradients summed in mesh order into the first
    replica's .grad (a replica with no gradient for it adds nothing); the
    other replicas' gradients are cleared."""
    params = [list(r.parameters()) for r in replicas]
    for group in zip(*params):
        grads = [p.grad for p in group if p.grad is not None]
        if grads:
            group[0].grad = reduce_to_first(grads, mesh)
        for p in group[1:]:
            p.grad = None


# -- the forwards of a mesh step, in lockstep --------------------------------

_local = threading.local()


class _Exchange:
    """The rendezvous of one mesh step's replica threads: all_reduce(rank,
    t) returns, on every entry, the sum over entries of their `t` (reduced
    onto the first entry in mesh order, then copied out), once every
    entry has given its own."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._slots: List[Optional[torch.Tensor]] = [None] * mesh.size
        self._out: List[torch.Tensor] = []
        self.barrier = threading.Barrier(mesh.size, action=self._reduce)

    def _reduce(self) -> None:
        self._out = broadcast_from_first(reduce_to_first(self._slots, self.mesh),
                                         self.mesh)

    def all_reduce(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        self._slots[rank] = t
        self.barrier.wait()
        return self._out[rank]


def in_mesh_step() -> bool:
    """Whether this thread runs one replica of a mesh step (run_replicas
    with more than one entry), whose batch is a share of the step's."""
    return getattr(_local, "exchange", None) is not None


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Inside a mesh step: the sum of `t` over every entry, on this
    entry's device (differentiable); every replica must call it, in the
    same order. Outside one: `t` itself."""
    ex = getattr(_local, "exchange", None)
    if ex is None:
        return t
    exchange, rank = ex
    return exchange.all_reduce(rank, t)


def run_replicas(fns: Sequence[Callable[[], object]], mesh: Mesh) -> list:
    """fns[i]() for every entry i, each in a thread of its own with entry
    i's device current and the caller's grad mode, so that layers which
    call all_reduce (models.layers.BatchNorm) meet in lockstep; returns
    the results in mesh order. A one-entry mesh calls fns[0] in the
    calling thread, with no exchange. The first error raised in any
    thread is raised here, after every thread has stopped."""
    if mesh.size == 1:
        return [fns[0]()]
    ex = _Exchange(mesh)
    out: list = [None] * mesh.size
    errors: List[Tuple[int, BaseException]] = []
    grad = torch.is_grad_enabled()

    def work(i: int) -> None:
        _local.exchange = (ex, i)
        try:
            dev = mesh.devices[i]
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            with torch.set_grad_enabled(grad):
                out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append((i, e))
            ex.barrier.abort()
        finally:
            _local.exchange = None

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # the thread that failed first, not one its abort broke
        real = [e for _, e in errors if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or [errors[0][1]])[0]
    return out
