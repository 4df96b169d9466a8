"""Process groups in place of ``shard_map`` mesh axes.

Counterpart of the collectives in ``repro/core/compat.py``.  A
:class:`Group` wraps a ``torch.distributed`` process group and stands for
one mesh axis: ``axis_index``/``axis_size`` read its rank and size, and
``ppermute``/``all_gather``/``psum`` are its collectives.  Without an
initialised process group a ``Group`` is the single-rank axis, so a
``world=1`` step needs no ``torch.distributed`` at all.

Three transports, chosen by the caller (``run_ranks(backend=...)``, or
``Group(transport=...)``) and never swapped silently:

``gloo``      Any device.  CUDA payloads are staged through host memory
              explicitly (copy to the host, send, copy back), which lets
              several ranks share one card.
``nccl``      One rank per card, CUDA tensors sent from device memory.  A
              group refuses to form when two ranks share a device,
              because NCCL refuses that.  Unverified until a multi-card
              run exists.
``cuda_ipc``  Ranks of one host, any number to a card.  A gloo process
              group sets channels up and tears them down; ``ppermute``
              and ``all_gather`` payloads stay in device memory.  Each
              rank owns receive slots and a mailbox in shared host
              memory that its peers map once (:class:`IpcChannel`, the
              paper's pointer cache); a hop is a device-to-device copy
              into the target's slot through that mapping, an
              interprocess CUDA event and a control message in the
              target's mailbox.  CPU tensors take the same protocol over
              shared memory.  ``psum`` stays gloo's host-staged allreduce: it
              is the vendor baseline (NCCL2's), which ranks sharing one
              card cannot run.  A group refuses to form unless every
              rank is on this host, and an export or a mapping that
              fails raises on every rank; nothing falls back to staging.

:func:`run_ranks` spawns the ranks of a job with file rendezvous.

With telemetry on, each collective records what this rank put on the
wire, where it puts it: the innermost open span around a ppermute (the
``hop[k]`` span the reducers open around each hop) gains
``sent_bytes`` and ``sent_parts`` (``[dtype, bytes]`` per tensor sent,
the payload first, by its element type even where gloo ships its raw
bytes) and ``sent_dtype`` (the payload's); ``psum`` and ``all_gather``
open a ``trace`` span of their own (``psum``, ``all_gather``) with the
same fields and ``kind``.  ``analysis/hop_lint.py`` reads these spans.
With telemetry off nothing is recorded.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist
from torch.multiprocessing import reductions

from ..telemetry import trace as telemetry_trace

TRANSPORTS = ("gloo", "nccl", "cuda_ipc")

# Bytes each transport moved, for the trace split: payload bytes gloo
# staged between the card and the host, bytes written into peers' slots
# through the cuda_ipc mappings, and cuda_ipc control messages.
traffic = {"staged_bytes": 0, "mapped_bytes": 0, "control_messages": 0}

# The transport the world group was started with (init_process_group);
# a cuda_ipc world runs on a gloo process group, so the backend alone
# cannot say which transport the caller chose.
_world_transport: str | None = None

# Channels open in this process, in the order they were opened (close
# order of close_channels()).
_open_channels: list = []
_channels_opened = 0


def _span(name: str):
    return torch.profiler.record_function(name)


_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def _spans(name: str, tracer):
    with _span(name), tracer.span(name, cat="trace"):
        yield


def _wait_span(name: str):
    """A control wait: a profiler range while a profiler records, and
    with telemetry on a ``trace`` span under the hop's (the split of a
    hop's host time into issue and waits); nothing while neither records
    (a hop's waits are its hottest host path)."""
    tracer = telemetry_trace.get_tracer()
    if torch._C._autograd._profiler_enabled():
        return _spans(name, tracer)
    return tracer.span(name, cat="trace") if tracer.enabled else _NO_SPAN


def _mailbox_lib():
    """``csrc/mailbox.cu``'s post and wait, built at first use."""
    from ..kernels import backend
    lib = backend.load("mailbox")
    if not getattr(lib, "_typed", False):
        lib.mailbox_post.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 3
        lib.mailbox_post.restype = ctypes.c_int64
        lib.mailbox_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_double, ctypes.c_void_p]
        lib.mailbox_wait.restype = ctypes.c_int
        lib._typed = True
    return lib


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sent(parts) -> list:
    """``[[dtype, bytes], ...]`` of the tensors ``parts`` sent once
    each."""
    return [[_dtype_name(p.dtype), p.numel() * p.element_size()]
            for p in parts]


def _note_sent(span, sent, kind) -> None:
    span.attrs["kind"] = kind
    span.attrs.setdefault("sent_parts", []).extend(sent)
    span.attrs["sent_bytes"] = span.attrs.get("sent_bytes", 0) \
        + sum(b for _, b in sent)
    if sent and "sent_dtype" not in span.attrs:
        span.attrs["sent_dtype"] = sent[0][0]


def _record_hop(parts, sends: bool) -> None:
    """Add what this rank sends on a ppermute to the innermost open
    span (nothing when telemetry is off or no span is open)."""
    tracer = telemetry_trace.get_tracer()
    span = tracer.current() if tracer.enabled else None
    if span is not None:
        _note_sent(span, _sent(parts) if sends else [],
                   "collective-permute")


def _vendor_span(name: str, kind: str, x: torch.Tensor, copies: int):
    """A ``trace`` span around a vendor collective that sends ``copies``
    copies of ``x`` (the shared no-op when telemetry is off)."""
    tracer = telemetry_trace.get_tracer()
    ctx = tracer.span(name, cat="trace")
    if tracer.enabled:
        _note_sent(ctx.span, _sent([x] * copies), kind)
    return ctx


def init_process_group(transport: str, init_method: str, rank: int,
                       world_size: int) -> None:
    """``torch.distributed.init_process_group`` for one of
    :data:`TRANSPORTS` (``cuda_ipc`` runs on a gloo group); the world
    :class:`Group` takes ``transport`` as its own."""
    global _world_transport
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} not in {TRANSPORTS}")
    backend = "gloo" if transport == "cuda_ipc" else transport
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _world_transport = transport


class Group:
    """One mesh axis: a process group (``None`` = the world group).

    ``transport`` defaults to what the world was started with for a
    gloo group (``gloo`` or ``cuda_ipc``), else the group's backend.  A
    cuda_ipc group moves payloads only once a channel is bound to it
    (:class:`IpcChannel`; a ``StageExecutor`` opens one)."""

    def __init__(self, pg=None, name: str = "data",
                 transport: str | None = None):
        self.name = name
        self.pg = pg
        self.channel = None
        if dist.is_available() and dist.is_initialized():
            self.backend = dist.get_backend(pg)
            self.size = dist.get_world_size(pg)
            self.rank = dist.get_rank(pg)
            self._global = [r if pg is None else dist.get_global_rank(pg, r)
                            for r in range(self.size)]
            if transport is None:
                transport = (_world_transport if self.backend == "gloo"
                             and _world_transport == "cuda_ipc"
                             else self.backend)
            want = "gloo" if transport == "cuda_ipc" else transport
            if transport not in TRANSPORTS or want != self.backend:
                raise ValueError(f"group {name!r}: transport {transport!r} "
                                 f"cannot run on a {self.backend} process "
                                 f"group")
            self.transport = transport
            if transport == "nccl":
                self._check_one_rank_per_device()
            elif transport == "cuda_ipc":
                self._check_one_host()
        else:
            self.backend = self.transport = None
            self.size, self.rank, self._global = 1, 0, [0]

    def _check_one_rank_per_device(self):
        devices = [None] * self.size
        dist.all_gather_object(devices, torch.cuda.current_device(),
                               group=self.pg)
        if len(set(devices)) != self.size:
            raise RuntimeError(
                f"nccl group {self.name!r}: ranks share a device "
                f"{devices}; NCCL needs one rank per card (use gloo)")

    def _check_one_host(self):
        hosts = [None] * self.size
        dist.all_gather_object(hosts, socket.gethostname(), group=self.pg)
        if len(set(hosts)) != 1:
            raise RuntimeError(
                f"cuda_ipc group {self.name!r} spans hosts {hosts}; CUDA "
                f"IPC maps memory of one host only (use gloo or nccl)")

    def global_rank(self, r: int) -> int:
        return self._global[r]

    def bind(self, channel) -> "Group":
        """This group with ``channel`` carrying its payloads."""
        bound = copy.copy(self)
        bound.channel = channel
        return bound

    def host_staged(self, x: torch.Tensor) -> bool:
        """True when ``x`` must travel through host memory (gloo's
        point-to-point and every gloo collective)."""
        return self.backend == "gloo" and x.device.type == "cuda"


def axis_index(group: Group) -> int:
    return group.rank


def axis_size(group: Group) -> int:
    return group.size


# ---------------------------------------------------------------------------
# cuda_ipc: receive slots mapped once, device copies, control messages
# ---------------------------------------------------------------------------

SLOTS = 2          # receive slots per ordered pair of ranks
ALIGN = 16         # every part of a payload starts 16-byte aligned
MAILBOX_TIMEOUT_S = 300.0   # a control wait longer than this raises
_NOTIFY, _ACK = 0, 1        # the two cells a peer writes in a mailbox


def _round_up(n: int) -> int:
    return -(-int(n) // ALIGN) * ALIGN


def slot_bytes(part_nbytes) -> int:
    """Bytes of the slot that holds payload parts of these sizes."""
    return sum(_round_up(n) for n in part_nbytes)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _export(t: torch.Tensor):
    """A picklable handle to ``t``'s memory: CUDA IPC for a CUDA tensor
    (``reduce_tensor``), a shared-memory file for a CPU tensor."""
    if t.is_cuda:
        return ("cuda", reductions.reduce_tensor(t))
    return ("shm", t.untyped_storage()._share_filename_cpu_(),
            tuple(t.shape))


def _import(handle) -> torch.Tensor:
    """Map a peer's exported tensor into this process."""
    kind, *rest = handle
    if kind == "cuda":
        rebuild, args = rest[0]
        return rebuild(*args)
    meta, shape = rest
    storage = torch.UntypedStorage._new_shared_filename_cpu(*meta)
    return torch.empty(0, dtype=torch.uint8).set_(
        storage, 0, shape, torch.empty(shape, device="meta").stride())


def _gather_or_raise(group: Group, what: str, err) -> list:
    """All-gather each rank's failure (or None) so that a failure on
    one rank raises on every rank instead of leaving them waiting."""
    errs = [None] * group.size
    dist.all_gather_object(errs, None if err is None else repr(err),
                           group=group.pg)
    bad = {r: e for r, e in enumerate(errs) if e is not None}
    if bad:
        raise RuntimeError(f"cuda_ipc group {group.name!r}: {what} failed "
                           f"on rank(s) {bad}") from err
    return errs


class IpcChannel:
    """The cuda_ipc transport between the ranks of one group.

    Each rank owns, for every peer, ``SLOTS`` receive slots of
    ``slot_bytes`` on ``device`` that only that peer writes, and one
    mailbox in shared host memory: for every peer a notify cell and an
    acknowledgement cell that only that peer writes (four int64 each,
    ``(gen, seq, slot, bytes)``).  Opening a channel is collective:
    every rank exports its slots, its mailbox (and, on CUDA, its
    interprocess events) once, gathers the peers' handles, and maps each
    once, keyed by peer; later hops reuse those mappings (the paper's
    pointer cache, Sec. V-B).  ``channel.group`` is the group with this
    channel bound.

    A hop from ``s`` to ``t`` (:meth:`post`, :meth:`take`,
    :meth:`finish`): ``s`` makes its stream wait for ``t``'s
    acknowledgement of the payload that last used the slot, copies into
    the slot through its mapping, records its event for the slot, and
    only then publishes ``(seq, slot, bytes)`` in its cell of ``t``'s
    mailbox (release ordering).  ``t`` waits for it (acquire ordering),
    makes its stream wait for that event, consumes the slot in place,
    records its own event and publishes the acknowledgement in its cell
    of ``s``'s mailbox, which ``s`` waits for before the collective call
    returns.  So no control message outlives the call that sent it, and
    with two slots a payload is written while the one before it may
    still be read on the card.  A message other than the one expected
    raises.  On CUDA the writes and waits run in ``csrc/mailbox.cu``,
    called with the interpreter lock released; on the CPU the wait polls
    in Python.  A wait that outlasts :data:`MAILBOX_TIMEOUT_S` (read when
    the channel opens) raises, naming the peer, the channel and the
    sequence number it expected.

    :meth:`close` is collective too: it unmaps the peers' slots and
    mailboxes on every rank, and only then frees this rank's own."""

    def __init__(self, group: Group, slot_bytes: int, device):
        global _channels_opened
        if group.transport != "cuda_ipc":
            raise ValueError(f"group {group.name!r} uses transport "
                             f"{group.transport!r}, not cuda_ipc")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.slot_bytes = _round_up(max(int(slot_bytes), 1))
        self.timeout_s = MAILBOX_TIMEOUT_S
        self.closed = False
        self.group = group.bind(self)
        self._cuda = self.device.type == "cuda"
        me = group.rank
        self._peers = [q for q in range(group.size) if q != me]
        # The channel's number: the same on every rank, apart from every
        # other channel this process has opened (it names the channel in
        # errors).
        idx = [None] * group.size
        dist.all_gather_object(idx, _channels_opened, group=group.pg)
        self.index = max(idx)
        _channels_opened = self.index + 1
        self.name = f"{group.name}#{self.index}"
        self._sent = {q: 0 for q in self._peers}
        self._taken = {q: 0 for q in self._peers}
        self._register()
        _open_channels.append(self)

    # -- registration -------------------------------------------------------

    def _event(self):
        return torch.cuda.Event(enable_timing=False, blocking=False,
                                interprocess=True)

    def _register(self):
        g, me = self.group, self.group.rank
        record, err = None, None
        try:
            # recv[q]: slots q writes into; notify[q]: recorded after
            # this rank writes into q's slots; ack[q]: recorded after
            # this rank has consumed what q wrote.  On CUDA the slots
            # take a memory pool of their own: they live as long as the
            # channel, and carved out of a cached block they left the
            # step's temporaries too little room (phase 6, gemma-7b on
            # one H100: the card held 71.32 GiB with them in the shared
            # pool, 66.20 with a pool of their own).
            self._lib = _mailbox_lib() if self._cuda else None
            self._pool = torch.cuda.MemPool() if self._cuda else None
            with torch.cuda.use_mem_pool(self._pool) if self._cuda \
                    else contextlib.nullcontext():
                self._recv = {q: torch.zeros((SLOTS, self.slot_bytes),
                                             dtype=torch.uint8,
                                             device=self.device)
                              for q in self._peers}
            self._notify = {q: [self._event() for _ in range(SLOTS)]
                            if self._cuda else None for q in self._peers}
            self._ack = {q: [self._event() for _ in range(SLOTS)]
                         if self._cuda else None for q in self._peers}
            # box[q, NOTIFY]: q's notifies to this rank; box[q, ACK]:
            # q's acknowledgements of what this rank sent it.
            self._box = torch.zeros((g.size, 2, 4), dtype=torch.int64)
            record = ({q: (_export(self._recv[q]),
                           self._ipc_handles(self._notify[q]),
                           self._ipc_handles(self._ack[q]))
                       for q in self._peers},
                      _export(self._box.view(torch.uint8)))
        except (RuntimeError, OSError) as e:
            err = e
        _gather_or_raise(g, "exporting receive slots", err)
        records = [None] * g.size
        dist.all_gather_object(records, record, group=g.pg)
        self._send, self._peer_notify, self._peer_ack = {}, {}, {}
        self._peer_box = {}
        try:
            for q in self._peers:
                area, notify, ack = records[q][0][me]
                self._send[q] = _import(area)
                self._peer_notify[q] = self._open_events(notify)
                self._peer_ack[q] = self._open_events(ack)
                if self._send[q].shape != (SLOTS, self.slot_bytes):
                    raise RuntimeError(f"rank {q}'s slots have shape "
                                       f"{tuple(self._send[q].shape)}")
                box = _import(records[q][1])
                if box.shape != (g.size, 2, 32):
                    raise RuntimeError(f"rank {q}'s mailbox has shape "
                                       f"{tuple(box.shape)}")
                self._peer_box[q] = box.view(torch.int64)
        except (RuntimeError, OSError) as e:
            err = e
        _gather_or_raise(g, "mapping the peers' receive slots", err)
        # What every hop touches, looked up once: each slot's view, and
        # each mailbox cell with its address (cells[q][kind]: q's cell in
        # this rank's mailbox; peer_cells[q][kind]: this rank's in q's).
        self._send_slots = {q: list(self._send[q]) for q in self._peers}
        self._recv_slots = {q: list(self._recv[q]) for q in self._peers}
        self._cells = {q: [self._cell(self._box[q, kind])
                           for kind in (_NOTIFY, _ACK)]
                       for q in self._peers}
        self._peer_cells = {q: [self._cell(self._peer_box[q][me, kind])
                                for kind in (_NOTIFY, _ACK)]
                            for q in self._peers}

    @staticmethod
    def _cell(view):
        return view, ctypes.c_void_p(view.data_ptr())

    def _ipc_handles(self, events):
        return None if events is None else [e.ipc_handle() for e in events]

    def _open_events(self, handles):
        if handles is None:
            return None
        return [torch.cuda.Event.from_ipc_handle(self.device, h)
                for h in handles]

    # -- control messages ---------------------------------------------------

    def _publish(self, q: int, kind: int, values) -> None:
        """Write ``(seq, slot, bytes)`` into this rank's ``kind`` cell of
        ``q``'s mailbox, then raise its gen."""
        cell, addr = self._peer_cells[q][kind]
        if self._cuda:
            self._lib.mailbox_post(addr, *values)
        else:
            cell[1:] = torch.tensor(values, dtype=torch.int64)
            cell[0] = int(cell[0]) + 1
        traffic["control_messages"] += 1

    def _wait(self, q: int, kind: int, want: list) -> None:
        """Wait for message number ``want[0] + 1`` in ``q``'s ``kind``
        cell of this rank's mailbox and check that it is ``want``
        (``(seq, slot, bytes)``)."""
        cell, addr = self._cells[q][kind]
        gen = want[0] + 1
        what = ("notify", "acknowledgement")[kind]
        if self._cuda:
            out = (ctypes.c_int64 * 4)()
            late = self._lib.mailbox_wait(addr, gen, self.timeout_s, out)
            got = list(out)
        else:
            late, t0, pause = 1, time.monotonic(), 0.0
            while time.monotonic() - t0 <= self.timeout_s:
                if int(cell[0]) >= gen:
                    late = 0
                    break
                time.sleep(pause)
                pause = min(1e-3, pause * 2 or 1e-5)
            got = cell.tolist()
        if late:
            raise TimeoutError(
                f"cuda_ipc channel {self.name}: no {what} from rank {q} "
                f"(global rank {self.group.global_rank(q)}) in "
                f"{self.timeout_s} s; expected seq {want[0]}")
        if got[0] != gen or got[1:1 + len(want)] != list(want):
            raise RuntimeError(
                f"cuda_ipc channel {self.name}: rank {q} sent the notify "
                f"{got[1:1 + len(want)]} (message {got[0]}), expected "
                f"(seq, slot, bytes) {list(want)} (message {gen})"
                if kind == _NOTIFY else
                f"cuda_ipc channel {self.name}: rank {q} acknowledged "
                f"{got[1:2]} (message {got[0]}), expected payload "
                f"{want[0]} (message {gen})")

    # -- a hop --------------------------------------------------------------

    def _layout(self, parts) -> list:
        """Byte offset of each part in a slot; raises when they do not
        fit."""
        offsets, off = [], 0
        for p in parts:
            if p.device != self.device:
                raise ValueError(f"cuda_ipc: a {p.device} payload on a "
                                 f"{self.device} channel")
            offsets.append(off)
            off += _round_up(p.numel() * p.element_size())
        if off > self.slot_bytes:
            raise ValueError(f"cuda_ipc: a hop of {off} bytes does not fit "
                             f"the channel's {self.slot_bytes}-byte slots")
        return offsets

    def post(self, q: int, parts) -> None:
        """Write ``parts`` into the next slot ``q`` reads from this rank."""
        offsets = self._layout(parts)
        seq = self._sent[q]
        k = seq % SLOTS
        stream = torch.cuda.current_stream(self.device) if self._cuda \
            else None
        if self._cuda and seq >= SLOTS:   # q has read the slot's last payload
            stream.wait_event(self._peer_ack[q][k])
        slot = self._send_slots[q][k]
        nbytes = 0
        for p, off in zip(parts, offsets):
            b = _as_bytes(p)
            slot[off:off + b.numel()].copy_(b)
            nbytes += b.numel()
        if self._cuda:
            self._notify[q][k].record(stream)
        self._publish(q, _NOTIFY, (seq, k, nbytes))
        traffic["mapped_bytes"] += nbytes
        self._sent[q] = seq + 1

    def take(self, q: int, like, consume):
        """Wait for ``q``'s next payload, shaped as the tensors ``like``,
        and return ``consume(*views of the slot)``.  The views are valid
        only inside ``consume``, which must not return one of them."""
        offsets = self._layout(like)
        seq = self._taken[q]
        k = seq % SLOTS
        nbytes = sum(t.numel() * t.element_size() for t in like)
        with _wait_span("cuda_ipc.notify_wait"):
            self._wait(q, _NOTIFY, [seq, k, nbytes])
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._peer_notify[q][k])
        slot = self._recv_slots[q][k]
        views = [slot[off:off + t.numel() * t.element_size()]
                 .view(t.dtype).reshape(t.shape)
                 for t, off in zip(like, offsets)]
        out = consume(*views)
        self._check_not_slot(out, slot)
        if self._cuda:
            self._ack[q][k].record(torch.cuda.current_stream(self.device))
        self._publish(q, _ACK, (seq, 0, 0))
        self._taken[q] = seq + 1
        return out

    def finish(self, posted) -> None:
        """End a collective call: wait for the acknowledgement of what
        this rank posted to each of ``posted`` (each peer has read it by
        then)."""
        for q in posted:
            with _wait_span("cuda_ipc.ack_wait"):
                self._wait(q, _ACK, [self._sent[q] - 1])

    @staticmethod
    def _check_not_slot(out, slot):
        base = slot.untyped_storage().data_ptr()
        for t in out if isinstance(out, (list, tuple)) else [out]:
            if isinstance(t, torch.Tensor) and \
                    t.untyped_storage().data_ptr() == base:
                raise RuntimeError("cuda_ipc: a consumer returned a view "
                                   "of its receive slot, which the next "
                                   "payload overwrites")

    # -- tear-down ----------------------------------------------------------

    def close(self) -> None:
        """Collective: unmap the peers' slots and events on every rank,
        then free this rank's own."""
        if self.closed:
            return
        self.closed = True
        if self._cuda:
            torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group.pg)
        self._send = self._peer_notify = self._peer_ack = None
        self._peer_box = self._send_slots = self._peer_cells = None
        dist.barrier(group=self.group.pg)
        # Every tensor from the slots' pool goes before the pool: one
        # still alive when the pool goes keeps its block out of the
        # allocator's reach.
        self._recv_slots = self._cells = self._box = None
        self._recv = self._notify = self._ack = self._pool = None
        if self._cuda:
            torch.cuda.ipc_collect()
        _open_channels.remove(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def close_channels() -> None:
    """Close every channel this process has open (collective: every
    rank must call it at the same point)."""
    for ch in list(_open_channels):
        ch.close()


def _channel(group: Group) -> IpcChannel:
    ch = group.channel
    if ch is None:
        raise RuntimeError(
            f"cuda_ipc group {group.name!r} has no channel: open one with "
            f"IpcChannel(group, slot_bytes, device) and use its .group "
            f"(a StageExecutor does)")
    if ch.closed:
        raise RuntimeError(f"cuda_ipc group {group.name!r}: its channel "
                           f"is closed")
    return ch


def _clone_all(*recv):
    return [t.clone() for t in recv]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _pair(group: Group, perm):
    me = group.rank
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"perm {perm} is not a permutation at rank {me}")
    return (dsts[0] if dsts else None), (srcs[0] if srcs else None)


def _gloo_ppermute(x: torch.Tensor, group: Group, dst, src) -> torch.Tensor:
    """One part over gloo, shipped as its bytes whatever its element
    type (a codec's float8 payload too)."""
    stage = group.host_staged(x)
    send = _as_bytes(x)
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send) if src is not None \
        else torch.zeros_like(send)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send, group.global_rank(dst),
                              group=group.pg))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv, group.global_rank(src),
                              group=group.pg))
    if ops:
        with _span("gloo.ppermute"):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if stage:
        traffic["staged_bytes"] += send.nbytes + recv.nbytes
        recv = recv.to(x.device)
    return recv.view(x.dtype).reshape(x.shape)


def ppermute_parts(parts, group: Group, perm, consume=None):
    """Send the tensors ``parts`` along the ``(src, dst)`` pairs of
    ``perm`` (group ranks) as ONE payload, and return
    ``consume(*received)`` (default: the received tensors, as a list).

    Like ``jax.lax.ppermute``, a rank that is no pair's target receives
    ZEROS: the RHD pre-fold and the codec's zero decode rely on it.  On
    gloo each part is its own point-to-point exchange.  On cuda_ipc the
    parts share one slot and one handshake, and ``consume`` reads the
    slot in place; it must return new tensors, never a view of what it
    was given."""
    parts = list(parts)
    dst, src = _pair(group, perm)
    _record_hop(parts, dst is not None and dst != group.rank)
    if group.transport == "cuda_ipc" and group.size > 1:
        ch = _channel(group)
        consume = consume or _clone_all
        if group.rank in (dst, src):
            raise ValueError(f"perm {perm} maps rank {group.rank} to "
                             f"itself")
        if dst is not None:
            ch.post(dst, parts)
        if src is not None:
            out = ch.take(src, parts, consume)
        else:
            out = consume(*[torch.zeros_like(p) for p in parts])
        ch.finish([] if dst is None else [dst])
        return out
    recv = [_gloo_ppermute(p, group, dst, src) for p in parts]
    return consume(*recv) if consume is not None else recv


def ppermute(x: torch.Tensor, group: Group, perm) -> torch.Tensor:
    """Send ``x`` along the ``(src, dst)`` pairs of ``perm`` (group
    ranks); a rank that is no pair's target receives zeros (see
    :func:`ppermute_parts`)."""
    return ppermute_parts([x], group, perm)[0]


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``(p, *x.shape)``: every rank's ``x`` in rank order.  On cuda_ipc
    every rank writes ``x`` into each peer's slot through its mapping
    and copies what the peers wrote into a new device tensor."""
    if group.size == 1:
        return x.unsqueeze(0)
    with _vendor_span("all_gather", "all-gather", x, group.size - 1):
        if group.transport == "cuda_ipc":
            ch = _channel(group)
            peers = [q for q in range(group.size) if q != group.rank]
            for q in peers:
                ch.post(q, [x])
            out = torch.empty((group.size,) + tuple(x.shape),
                              dtype=x.dtype, device=x.device)
            out[group.rank].copy_(x)
            for q in peers:
                ch.take(q, [x], out[q].copy_)
            ch.finish(peers)
            return out
        stage = group.host_staged(x)
        src = x.contiguous().cpu() if stage else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(group.size)]
        with _span("gloo.all_gather"):
            dist.all_gather(parts, src, group=group.pg)
        out = torch.stack(parts).to(x.device)
        if stage:
            traffic["staged_bytes"] += src.nbytes + out.nbytes
        return out


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the group (the vendor allreduce, NCCL2's baseline).  On
    gloo and cuda_ipc a CUDA ``x`` is staged through host memory."""
    if group.size == 1:
        return x
    with _vendor_span("psum", "all-reduce", x, 1):
        stage = group.host_staged(x)
        y = x.detach().cpu().clone() if stage else x.detach().clone()
        with _span("gloo.psum"):
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group.pg)
        if stage:
            traffic["staged_bytes"] += 2 * y.nbytes
        return y.to(x.device)


# ---------------------------------------------------------------------------
# Spawning the ranks of a job
# ---------------------------------------------------------------------------

def _rank_entry(rank, world, backend, init_file, threads, fn, args, results):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    init_process_group(backend, f"file://{init_file}", rank, world)
    try:
        out = fn(rank, world, *args)
        close_channels()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), *, backend: str = "gloo",
              rendezvous_dir: str, threads: int | None = None,
              timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    share one process group of transport ``backend`` (one of
    :data:`TRANSPORTS`; file rendezvous in ``rendezvous_dir``).  Returns
    each rank's result in rank order; the channels ``fn`` left open are
    closed after it returns.  Raises when a rank fails or the job
    outlasts ``timeout_s``; every process is stopped before it returns.
    ``fn`` must be importable (a module-level function)."""
    if backend not in TRANSPORTS:
        raise ValueError(f"backend {backend!r} not in {TRANSPORTS}")
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
