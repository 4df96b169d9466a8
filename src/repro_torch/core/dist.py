"""Process groups in place of ``shard_map`` mesh axes.

Counterpart of the collectives in ``repro/core/compat.py``.  A
:class:`Group` wraps a ``torch.distributed`` process group and stands for
one mesh axis: ``axis_index``/``axis_size`` read its rank and size, and
``ppermute``/``all_gather``/``psum`` are its collectives.  Without an
initialised process group a ``Group`` is the single-rank axis, so a
``world=1`` step needs no ``torch.distributed`` at all.

Two transports, chosen by the caller through the process group's backend
and never swapped silently:

``gloo``  Any device.  CUDA payloads are staged through host memory
          explicitly (copy to the host, send, copy back), which lets
          several ranks share one card.
``nccl``  One rank per card, CUDA tensors sent from device memory.  A
          group refuses to form when two ranks share a device, because
          NCCL refuses that.  Unverified until a multi-card run exists.

:func:`run_ranks` spawns the ranks of a job with file rendezvous.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback

import torch
import torch.distributed as dist


class Group:
    """One mesh axis: a process group (``None`` = the world group)."""

    def __init__(self, pg=None, name: str = "data"):
        self.name = name
        self.pg = pg
        if dist.is_available() and dist.is_initialized():
            self.backend = dist.get_backend(pg)
            self.size = dist.get_world_size(pg)
            self.rank = dist.get_rank(pg)
            self._global = [r if pg is None else dist.get_global_rank(pg, r)
                            for r in range(self.size)]
            if self.backend == "nccl":
                self._check_one_rank_per_device()
        else:
            self.backend = None
            self.size, self.rank, self._global = 1, 0, [0]

    def _check_one_rank_per_device(self):
        devices = [None] * self.size
        dist.all_gather_object(devices, torch.cuda.current_device(),
                               group=self.pg)
        if len(set(devices)) != self.size:
            raise RuntimeError(
                f"nccl group {self.name!r}: ranks share a device "
                f"{devices}; NCCL needs one rank per card (use gloo)")

    def global_rank(self, r: int) -> int:
        return self._global[r]

    def host_staged(self, x: torch.Tensor) -> bool:
        """True when ``x`` must travel through host memory."""
        return self.backend == "gloo" and x.device.type == "cuda"


def axis_index(group: Group) -> int:
    return group.rank


def axis_size(group: Group) -> int:
    return group.size


def ppermute(x: torch.Tensor, group: Group, perm) -> torch.Tensor:
    """Send ``x`` along the ``(src, dst)`` pairs of ``perm`` (group
    ranks).  Like ``jax.lax.ppermute``, a rank that is no pair's target
    receives ZEROS: the RHD pre-fold and the codec's zero decode rely on
    it, and torch's point-to-point leaves a receive buffer untouched, so
    the buffer is zero-filled here."""
    me = group.rank
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"perm {perm} is not a permutation at rank {me}")
    stage = group.host_staged(x)
    send = x.contiguous()
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send) if srcs else torch.zeros_like(send)
    ops = []
    if dsts:
        ops.append(dist.P2POp(dist.isend, send, group.global_rank(dsts[0]),
                              group=group.pg))
    if srcs:
        ops.append(dist.P2POp(dist.irecv, recv, group.global_rank(srcs[0]),
                              group=group.pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if stage else recv


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``(p, *x.shape)``: every rank's ``x`` in rank order."""
    if group.size == 1:
        return x.unsqueeze(0)
    stage = group.host_staged(x)
    src = x.contiguous().cpu() if stage else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.stack(parts).to(x.device)


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the group (the vendor allreduce, NCCL2's baseline)."""
    if group.size == 1:
        return x
    stage = group.host_staged(x)
    y = x.detach().cpu().clone() if stage else x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group.pg)
    return y.to(x.device)


# ---------------------------------------------------------------------------
# Spawning the ranks of a job
# ---------------------------------------------------------------------------

def _rank_entry(rank, world, backend, init_file, threads, fn, args, results):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), *, backend: str = "gloo",
              rendezvous_dir: str, threads: int | None = None,
              timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    share one ``backend`` process group (file rendezvous in
    ``rendezvous_dir``).  Returns each rank's result in rank order.
    Raises when a rank fails or the job outlasts ``timeout_s``; every
    process is stopped before it returns.  ``fn`` must be importable
    (a module-level function)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r} not in ('gloo', 'nccl')")
    init_file = os.path.join(rendezvous_dir, f"rendezvous-{os.getpid()}-"
                                             f"{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, backend, init_file, threads, fn,
                               args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    try:
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"ranks did not finish in {timeout_s} s "
                                   f"({sorted(out)} reported)")
            try:
                rank, ok, val = results.get(timeout=min(remaining, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died without a "
                                       f"result (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
