"""Process-group plumbing of the multi-GPU paths: what the JAX package's
device mesh gives for free.

One process a rank, ``torch.distributed`` between them.  ``init_group``
takes the rank, the world size and the device from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``) or
from its arguments, and returns a ``Group`` that the parallel modules
take: its collectives are the ones the JAX modules call inside
``shard_map`` (``exchange`` for the paired ``ppermute`` of a slab halo,
``psum`` / ``pmax`` for ``lax.psum`` / ``lax.pmax``) plus what a process
per rank needs besides (``all_gather``, ``gather``, ``broadcast``,
``scatter_object``, ``barrier``).

The backend and the device are the caller's choice: NCCL for CUDA tensors,
gloo for CPU tensors.  Gloo moves CPU tensors only here, so a gloo group
whose ranks hold CUDA tensors (two ranks on one card, where NCCL refuses
a second rank on the same device) copies each message through pinned host
buffers; ``Group.transport`` names the route ("nccl", "gloo", or "gloo
via pinned host memory").  It is chosen by the backend and the device,
never on failure.

``spawn`` starts ``world_size`` ranks with the ``spawn`` start method (no
``fork`` after CUDA is initialised) around a ``FileStore`` in a fresh
temporary directory, so parallel test workers never race for a TCP port.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

#: how long a rank waits in a collective before it raises (the other
#: ranks wait at a barrier while rank 0 validates)
TIMEOUT_S = 1800


class Group:
    """This process's place in the default process group: ``rank``,
    ``world_size``, ``device`` (where its tensors live), ``backend`` and
    ``transport``."""

    def __init__(self, device, owns=False, store_dir=None):
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = torch.device(device)
        # where messages live: the card for NCCL, host memory for gloo
        self._comm = (torch.device("cpu") if self.backend == "gloo"
                      else self.device)
        staged = self.backend == "gloo" and self.device.type == "cuda"
        self.transport = ("gloo via pinned host memory" if staged
                          else self.backend)
        self._owns = owns
        self._store_dir = store_dir

    def __repr__(self):
        return (f"Group(rank={self.rank}, world_size={self.world_size}, "
                f"device={self.device}, transport={self.transport!r})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Ends the process group where ``init_group`` started it."""
        if self._owns and dist.is_initialized():
            dist.destroy_process_group()
            self._owns = False
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None

    # -- messages where the backend takes them ----------------------------

    def _pinned(self, like):
        """Host staging of a CUDA tensor for gloo."""
        return self._comm.type == "cpu" and like.device.type == "cuda"

    def _out(self, t):
        """A contiguous copy of ``t`` where the backend takes it (pinned
        host memory for gloo with a CUDA tensor)."""
        t = t.detach()
        h = torch.empty(t.shape, dtype=t.dtype, device=self._comm,
                        pin_memory=self._pinned(t))
        return h.copy_(t)

    def _buf(self, like):
        """A zero-filled receive buffer of ``like``'s shape where the
        backend takes it."""
        return torch.zeros(like.shape, dtype=like.dtype, device=self._comm,
                           pin_memory=self._pinned(like))

    @staticmethod
    def _back(h, like):
        return h if h.device == like.device else h.to(like.device)

    # -- collectives -------------------------------------------------------

    def exchange(self, send_right, send_left):
        """The slab halo's paired ``ppermute``: rank r sends
        ``send_right`` to rank r + 1 and ``send_left`` to rank r - 1, and
        returns ``(recv_left, recv_right)``, what r - 1 sent right and
        r + 1 sent left.  Where a rank has no neighbour (the ends of the
        chain) the buffer it returns is zeros, as ``ppermute`` gives.
        Raises on an input that requires a gradient: the exchange is not
        differentiated (the halo losses differentiate parameters only)."""
        for t in (send_right, send_left):
            if t.requires_grad:
                raise ValueError(
                    "Group.exchange does not differentiate its inputs; "
                    "detach them (parameters' gradients are summed with "
                    "psum_grads)")
        recv_left, recv_right = self._buf(send_right), self._buf(send_left)
        ops = []
        if self.rank + 1 < self.world_size:
            ops += [dist.P2POp(dist.isend, self._out(send_right),
                               self.rank + 1),
                    dist.P2POp(dist.irecv, recv_right, self.rank + 1)]
        if self.rank > 0:
            ops += [dist.P2POp(dist.isend, self._out(send_left),
                               self.rank - 1),
                    dist.P2POp(dist.irecv, recv_left, self.rank - 1)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return (self._back(recv_left, send_right),
                self._back(recv_right, send_left))

    def _reduce(self, t, op):
        h = self._out(t)
        dist.all_reduce(h, op=op)
        return self._back(h, t)

    def psum(self, t):
        """Sum of ``t`` over the ranks (``lax.psum``); a new tensor."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t):
        """Elementwise largest ``t`` over the ranks; a new tensor."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t):
        """[world_size, *t.shape]: every rank's ``t`` in rank order."""
        h = self._out(t)
        parts = [torch.empty_like(h) for _ in range(self.world_size)]
        dist.all_gather(parts, h)
        return self._back(torch.stack(parts), t)

    def all_gather_rows(self, t, n):
        """[n, ...]: an n-row array whose rows the ranks hold in blocks
        (rank r rows ``row_block(n, world_size, r)``), from each rank's
        block ``t``.  The blocks need not be equal: each is padded to the
        largest before the all-gather and trimmed after it.  Bool tensors
        travel as uint8."""
        w = self.world_size
        blocks = [row_block(n, w, r) for r in range(w)]
        lo, hi = blocks[self.rank]
        if t.shape[0] != hi - lo:
            raise ValueError(f"all_gather_rows: rank {self.rank} holds "
                             f"{t.shape[0]} rows, its block of {n} is "
                             f"{hi - lo}")
        width = max(b - a for a, b in blocks)
        x = t.to(torch.uint8) if t.dtype == torch.bool else t
        if x.shape[0] < width:
            x = torch.cat([x, x.new_zeros((width - x.shape[0],
                                           *x.shape[1:]))])
        parts = self.all_gather(x)
        out = torch.cat([parts[r, :b - a] for r, (a, b) in enumerate(blocks)])
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def broadcast(self, t, src=0):
        """``t`` overwritten in place with rank ``src``'s values."""
        h = self._out(t)
        dist.broadcast(h, src=src)
        with torch.no_grad():
            t.copy_(h)
        return t

    def gather(self, t, dst=0):
        """[world_size, *t.shape], every rank's ``t`` in rank order, on
        rank ``dst``; None on the others."""
        h = self._out(t)
        parts = ([torch.empty_like(h) for _ in range(self.world_size)]
                 if self.rank == dst else None)
        dist.gather(h, parts, dst=dst)
        return self._back(torch.stack(parts), t) if parts else None

    def scatter_object(self, objs, src=0):
        """Rank r's item of rank ``src``'s list ``objs`` (one picklable
        object a rank) on rank r; the other ranks pass None."""
        box = [None]
        dist.scatter_object_list(box, objs if self.rank == src else None,
                                 src=src)
        return box[0]

    def barrier(self):
        """Waits until every rank has come here."""
        self.psum(torch.zeros(1, device=self.device))

    def psum_grads(self, params):
        """Each parameter's ``.grad`` summed over the ranks in place, in
        one flat all-reduce (parameters without a gradient count zeros,
        so every rank sends the same buffer)."""
        params = list(params)
        if not params:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        flat = self.psum(flat)
        off = 0
        for p in params:
            n = p.numel()
            g = flat[off:off + n].view_as(p)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
            off += n

    def broadcast_params(self, module, src=0):
        """Every parameter and buffer of ``module`` set to rank ``src``'s."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self.broadcast(t.data, src=src)


def row_block(n, world_size, rank):
    """(lo, hi): rank ``rank``'s contiguous block of ``n`` rows split over
    ``world_size`` ranks, the first ``n % world_size`` blocks one row
    longer (at most ``ceil(n / world_size)`` rows; no block is empty
    where n >= world_size)."""
    base, extra = divmod(int(n), int(world_size))
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def env_rank():
    """(rank, world size, local rank) from ``torchrun``'s environment, or
    (0, 1, 0) outside it."""
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def is_main_rank():
    """Whether this process is rank 0 (of the running process group, else
    of ``torchrun``'s environment): the one that writes."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return env_rank()[0] == 0


def rank_device(device="cuda"):
    """The device a rank runs on: ``cuda:LOCAL_RANK`` for "cuda" (raises
    without a card, as every entry point does), else ``device`` as given
    (``cuda:0`` for two ranks sharing one card)."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", env_rank()[2])
    return dev


def init_group(device="cuda", backend=None, *, rank=None, world_size=None,
               init_method=None):
    """Joins (or, where one is running, wraps) the default process group.

    ``rank`` and ``world_size`` default to ``torchrun``'s environment; a
    world of one needs no environment (a ``FileStore`` in a temporary
    directory).  ``backend`` defaults to NCCL for a CUDA device and gloo
    for the CPU.  Returns a ``Group`` (a context manager that ends the
    group it started)."""
    env = env_rank()
    rank = env[0] if rank is None else rank
    world_size = env[1] if world_size is None else world_size
    dev = rank_device(device)
    if dist.is_initialized():
        return Group(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if backend == "nccl":       # the communicator bound to the card up front
        kw["device_id"] = dev
    tmp = None
    if init_method is not None:
        kw["init_method"] = init_method
    elif "MASTER_ADDR" in os.environ:
        kw["init_method"] = "env://"
    elif world_size == 1:
        tmp = tempfile.mkdtemp(prefix="dmcf_pg_")
        kw["store"] = dist.FileStore(os.path.join(tmp, "store"), 1)
    else:
        raise RuntimeError(
            f"init_group: world size {world_size} needs torchrun's "
            "environment (MASTER_ADDR) or an init_method")
    dist.init_process_group(**kw)
    return Group(dev, owns=True, store_dir=tmp)


def _rank_entry(rank, fn, world_size, store_dir, backend, devices, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, store=store, rank=rank,
              world_size=world_size,
              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    try:
        out = fn(Group(dev), *args)
        torch.save(out, os.path.join(store_dir, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size, *, backend="gloo", devices=None, args=()):
    """Runs ``fn(group, *args)`` on ``world_size`` new processes (start
    method ``spawn``, one thread each; ``devices[rank]`` a rank's device,
    default the CPU) and returns their results in rank order.  ``fn``
    must be a module-level function of a module that imports no JAX, and
    its result CPU tensors or plain Python / numpy objects.  A rank that
    raises ends the others, and ``spawn`` raises its error."""
    import torch.multiprocessing as mp

    devices = list(devices or ["cpu"] * world_size)
    store_dir = tempfile.mkdtemp(prefix="dmcf_spawn_")
    try:
        mp.start_processes(
            _rank_entry, nprocs=world_size, start_method="spawn",
            args=(fn, world_size, store_dir, backend, devices, args))
        return [torch.load(os.path.join(store_dir, f"result{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
