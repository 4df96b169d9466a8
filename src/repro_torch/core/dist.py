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
              rank owns receive slots and, per peer, a notify and an
              acknowledgement counter in device memory, which its peers
              map once (:class:`IpcChannel`, the paper's pointer cache).
              A hop is enqueued on the stream and never waits on the
              host: the sender's stream waits on the card for the slot,
              copies into it through the mapping and writes the notify
              counter; the receiver's stream waits on the card for that
              value, consumes the slot and writes the acknowledgement
              (the driver's stream memory operations).  The host waits,
              with a deadline, only where it synchronises with the
              channel (:meth:`IpcChannel.sync`, :func:`sync_channels`,
              which every other host wait for the card on a channel's
              path calls first).  CPU tensors take slots
              and a mailbox in shared memory, polled by the host.
              ``psum`` stays gloo's host-staged allreduce: it
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
import itertools
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
# through the cuda_ipc mappings, cuda_ipc control messages (a notify and
# an acknowledgement per hop), and the waits for them a cuda_ipc channel
# enqueued on the card (``csrc/mailbox.cu``'s, counted as launches).
traffic = {"staged_bytes": 0, "mapped_bytes": 0, "control_messages": 0,
           "device_waits": 0}

# The transport the world group was started with (init_process_group);
# a cuda_ipc world runs on a gloo process group, so the backend alone
# cannot say which transport the caller chose.
_world_transport: str | None = None

# Channels open in this process, in the order they were opened (close
# order of close_channels()).
_open_channels: list = []
_channels_opened = 0
# The waits every channel of this process enqueued on the card, counted
# in the order they were enqueued.
_waits_enqueued = itertools.count()


def _span(name: str):
    return torch.profiler.record_function(name)


_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def _spans(name: str, tracer):
    with _span(name), tracer.span(name, cat="trace"):
        yield


def _wait_span(name: str):
    """A host wait of the transport: a profiler range while a profiler
    records, and with telemetry on a ``trace`` span under the open one
    (on the CPU a hop's, the split of its host time into issue and
    waits; on the card the channel's sync); nothing while neither
    records (a hop's waits are its hottest host path)."""
    tracer = telemetry_trace.get_tracer()
    if torch._C._autograd._profiler_enabled():
        return _spans(name, tracer)
    return tracer.span(name, cat="trace") if tracer.enabled else _NO_SPAN


_CONTROL: dict = {}     # device index -> csrc/mailbox.cu, opened
# Cells of pinned host memory the card writes (a channel's count of the
# waits the card has passed): (host array, the card's address of cell 0,
# free cell indices), allocated once per process.
CELLS = 1024
_cells: list = []


def _control_lib(device: torch.device):
    """``csrc/mailbox.cu``'s device waits and writes, built at first
    use.  Raises unless ``device`` has the driver's 64-bit stream memory
    operations: a channel on the card waits there, with no host
    fallback."""
    lib = _CONTROL.get(device.index)
    if lib is not None:
        return lib
    from ..kernels import backend
    lib = backend.load("mailbox")
    vp, u64, i64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
    lib.ipc_wait.argtypes = [vp, u64, u64, u64, u64]
    lib.ipc_wait.restype = ctypes.c_int
    lib.ipc_host_cells.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint64),
                                    ctypes.POINTER(ctypes.c_uint64)]
    lib.ipc_host_cells.restype = ctypes.c_int
    lib.ipc_signal.argtypes = [vp, vp, i64, i64, u64, u64]
    lib.ipc_signal.restype = ctypes.c_int
    lib.ipc_open.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ipc_open.restype = ctypes.c_int
    support = ctypes.c_int(0)
    rc = lib.ipc_open(device.index, ctypes.byref(support))
    if rc != 0:
        raise RuntimeError(f"cuda_ipc: the driver's stream memory "
                           f"operations could not be opened on {device} "
                           f"(error {rc})")
    if not support.value:
        raise RuntimeError(
            f"cuda_ipc: {device} has no 64-bit stream memory operations "
            f"(CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS is 0); a "
            f"channel waits for its peers on the card and has no host "
            f"fallback")
    _CONTROL[device.index] = lib
    return lib


def _host_cell(lib) -> tuple:
    """``(index, host view, the card's address)`` of a free cell of
    pinned host memory that the card writes; give it back with
    :func:`_free_cell`."""
    if not _cells:
        host, dev = ctypes.c_uint64(0), ctypes.c_uint64(0)
        rc = lib.ipc_host_cells(CELLS, ctypes.byref(host), ctypes.byref(dev))
        if rc != 0:
            raise RuntimeError(f"cuda_ipc: pinned host memory for the card "
                               f"could not be allocated (error {rc})")
        _cells[:] = [(ctypes.c_int64 * CELLS).from_address(host.value),
                     dev.value, list(range(CELLS))]
    array, dev, free = _cells
    if not free:
        raise RuntimeError(f"cuda_ipc: more than {CELLS} channels open")
    i = free.pop()
    array[i] = 0
    return i, array, dev + 8 * i


def _free_cell(i: int) -> None:
    _cells[2].append(i)


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
_NOTIFY, _ACK = 0, 1        # the two messages a peer sends
_KIND = ("notify", "acknowledgement")
LINE = 16          # int64 words in 128 bytes: one device counter's line
LOG = 1024         # byte-count log entries per peer (on the card)


# -- the sequence arithmetic, the same on both paths --------------------------

def counter_target(seq: int) -> int:
    """The value a peer's counter holds once its message ``seq`` of one
    kind is out: messages count from 1 (a CPU mailbox cell's
    generation, a device counter on the card)."""
    return seq + 1


def reuse_bound(seq: int) -> int:
    """The acknowledgement count that payload ``seq`` waits for before
    it is written into slot ``seq % SLOTS``: the peer has read the
    payload that last used that slot, ``seq - SLOTS``.  0 for the first
    ``SLOTS`` payloads."""
    return max(seq - SLOTS + 1, 0)


def check_message(channel: str, q: int, kind: int, got, want) -> None:
    """Raise unless the message from rank ``q`` is the one expected.
    ``got`` is ``[message number, *values]`` as it arrived, ``want`` the
    values expected: ``(seq, slot, bytes)`` for a notify, ``(seq,)`` for
    an acknowledgement; the message number expected is
    ``counter_target(want[0])``."""
    gen = counter_target(want[0])
    got = [int(v) for v in got]
    if got[0] == gen and got[1:1 + len(want)] == list(want):
        return
    if kind == _NOTIFY:
        raise RuntimeError(
            f"cuda_ipc channel {channel}: rank {q} sent the notify "
            f"{got[1:1 + len(want)]} (message {got[0]}), expected (seq, "
            f"slot, bytes) {list(want)} (message {gen})")
    raise RuntimeError(
        f"cuda_ipc channel {channel}: rank {q} acknowledged {got[1:2]} "
        f"(message {got[0]}), expected payload {want[0]} (message {gen})")


def late_error(channel: str, q: int, global_q: int, kind: int,
               timeout_s: float, seq: int) -> TimeoutError:
    """The error of a wait for ``q``'s message ``seq`` that outlasted
    ``timeout_s``."""
    return TimeoutError(
        f"cuda_ipc channel {channel}: no {_KIND[kind]} from rank {q} "
        f"(global rank {global_q}) in {timeout_s} s; expected seq {seq}")


def lagging(waits, passed: int):
    """``(q, kind, seq)`` of the first wait the card has not passed, or
    None.  ``waits`` are a channel's waits on the card in the order they
    were enqueued, each ``(q, kind, seq)``: a take of ``seq`` waits for
    ``q``'s notify ``seq`` (its counter at ``counter_target(seq)``), a
    post of ``seq`` for ``q``'s acknowledgement of payload ``seq``
    (``reuse_bound`` of the post's own number); ``passed`` is how many
    of them the card has passed.  The stream runs them in order, so the
    first not passed is the one it is blocked on."""
    return waits[passed] if passed < len(waits) else None


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


def _poll(done, deadline: float, longest: float = 2e-4) -> bool:
    """Poll ``done()`` until it is true (True) or the monotonic clock
    passes ``deadline`` (False), sleeping between polls from 10 µs,
    doubling up to ``longest`` seconds."""
    pause = 0.0
    while not done():
        if time.monotonic() > deadline:
            return False
        time.sleep(pause)
        pause = min(longest, pause * 2 or 1e-5)
    return True


class IpcChannel:
    """The cuda_ipc transport between the ranks of one group.

    Each rank owns, for every peer, ``SLOTS`` receive slots of
    ``slot_bytes`` on ``device`` that only that peer writes, and for
    every peer a notify counter and an acknowledgement counter that only
    that peer writes.  Opening a channel is collective: every rank
    exports its slots and counters once, gathers the peers' handles, and
    maps each once, keyed by peer; later hops reuse those mappings (the
    paper's pointer cache, Sec. V-B).  ``channel.group`` is the group
    with this channel bound.

    A hop from ``s`` to ``t`` is :meth:`post` on ``s``, :meth:`take` on
    ``t`` and :meth:`finish` on ``s``.  With two slots a payload is
    written while the one before it may still be read.  The counters
    follow :func:`counter_target` and :func:`reuse_bound`.

    On CUDA every step is enqueued on the current stream and the host
    never waits for a peer.  ``s``'s stream waits on the card until
    ``t``'s acknowledgement count reaches ``reuse_bound(seq)``, copies
    into the slot through its mapping, and writes ``seq + 1`` into its
    notify counter in ``t``'s memory (after a memory barrier).  Before
    it enqueues that write, ``s``'s host stores ``(seq, bytes)`` in its
    row of ``t``'s byte-count log, in shared host memory.  ``t``'s stream
    waits until that counter reaches ``seq + 1``, consumes the slot in
    place, and writes ``seq + 1`` into its acknowledgement counter in
    ``s``'s memory.  ``finish`` waits for nothing.  The counters are
    64-bit, each on a 128-byte line, in the channel's memory pool; the
    waits and writes are the driver's stream memory operations
    (``kernels/csrc/mailbox.cu``; a card without 64-bit ones makes the
    channel raise when it opens).  :meth:`sync` is where the host waits:
    it polls until the streams this rank used have run everything it
    enqueued, then checks the byte count of every payload taken since
    the last sync.  The end of an aggregate, an overlapped backward's
    join, the trainer's step and :meth:`close` sync; so does a collective
    call after ``LOG // 4`` hops since the last, and every other host
    wait for the card on a channel's path (:func:`sync_channels`).

    On the CPU the slots and a mailbox are shared host memory: for every
    peer a notify cell and an acknowledgement cell that only that peer
    writes (four int64 each, ``(gen, seq, slot, bytes)``).  ``s``
    publishes ``(seq, slot, bytes)`` after its copy; ``t`` waits for it
    (polling), consumes and publishes its acknowledgement, which ``s``
    waits for in :meth:`finish`.

    A message other than the one expected raises (:func:`check_message`).
    A wait that outlasts :data:`MAILBOX_TIMEOUT_S` (read when the channel
    opens) raises, naming the peer, the channel and the sequence number
    it expected (:func:`late_error`; on the card :meth:`sync`'s deadline,
    and the first wait the card has not passed names the peer,
    :func:`lagging`: each wait, once passed, writes its number into
    pinned host memory; of every open channel's, the first enqueued,
    since channels share streams).

    :meth:`close` is collective too: it syncs, checks that every counter
    reached its final value, unmaps the peers' slots and counters on
    every rank, and only then frees this rank's own."""

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
        # On the card: the streams used since the last sync (by handle),
        # the last one, the payloads taken and not yet checked, the hops
        # since the last sync, and the waits enqueued since then, each
        # (q, kind, seq), the first of them this channel's wait number
        # waited0 + 1, and each one's number among the process's waits.
        self._streams: dict = {}
        self._last_stream = None
        self._pending: list = []
        self._hops = 0
        self._waits: list = []
        self._wait_at: list = []
        self._waited0 = 0
        self.waits = 0              # waits enqueued on the card
        self._register()
        _open_channels.append(self)

    # -- registration -------------------------------------------------------

    def _register(self):
        g, me = self.group, self.group.rank
        record, err = None, None
        try:
            # recv[q]: slots q writes into.  On CUDA the slots and the
            # counters take a memory pool of their own: they live as long
            # as the channel, and carved out of a cached block they left
            # the step's temporaries too little room (phase 6, gemma-7b
            # on one H100: the card held 71.32 GiB with them in the
            # shared pool, 66.20 with a pool of their own).
            self._lib = _control_lib(self.device) if self._cuda else None
            self._pool = torch.cuda.MemPool() if self._cuda else None
            with torch.cuda.use_mem_pool(self._pool) if self._cuda \
                    else contextlib.nullcontext():
                self._recv = {q: torch.zeros((SLOTS, self.slot_bytes),
                                             dtype=torch.uint8,
                                             device=self.device)
                              for q in self._peers}
                # flags[q, 0]: q's notify count; flags[q, LINE]: q's
                # acknowledgement count (of what this rank sent q).
                self._flags = torch.zeros((g.size, 2 * LINE),
                                          dtype=torch.int64,
                                          device=self.device) \
                    if self._cuda else None
            if self._cuda:
                # log[q, seq % LOG]: (seq, bytes) of q's payload seq,
                # stored by q's host.  passed: the number of the last
                # wait the card has passed, written there after it (pinned
                # host memory the card writes and the host reads).
                self._box = torch.zeros((g.size, LOG, 2), dtype=torch.int64)
                self._cell, self._passed, self._passed_addr = \
                    _host_cell(self._lib)
            else:
                # box[q, NOTIFY]: q's notifies to this rank; box[q, ACK]:
                # q's acknowledgements of what this rank sent it.
                self._box = torch.zeros((g.size, 2, 4), dtype=torch.int64)
            # One export per peer of each CUDA tensor: a peer's mapping is
            # released against the export it came from.
            record = ({q: _export(self._recv[q]) for q in self._peers},
                      _export(self._box.view(torch.uint8)),
                      {q: _export(self._flags) for q in self._peers}
                      if self._cuda else None)
        except (RuntimeError, OSError) as e:
            err = e
        _gather_or_raise(g, "exporting receive slots", err)
        records = [None] * g.size
        dist.all_gather_object(records, record, group=g.pg)
        box_shape = tuple(self._box.view(torch.uint8).shape)
        self._send, self._peer_box, self._peer_flags = {}, {}, {}
        try:
            for q in self._peers:
                self._send[q] = _import(records[q][0][me])
                if self._send[q].shape != (SLOTS, self.slot_bytes):
                    raise RuntimeError(f"rank {q}'s slots have shape "
                                       f"{tuple(self._send[q].shape)}")
                box = _import(records[q][1])
                if tuple(box.shape) != box_shape:
                    raise RuntimeError(f"rank {q}'s mailbox has shape "
                                       f"{tuple(box.shape)}")
                self._peer_box[q] = box.view(torch.int64)
                if self._cuda:
                    self._peer_flags[q] = _import(records[q][2][me])
                    if tuple(self._peer_flags[q].shape) != \
                            tuple(self._flags.shape):
                        raise RuntimeError(
                            f"rank {q}'s counters have shape "
                            f"{tuple(self._peer_flags[q].shape)}")
        except (RuntimeError, OSError) as e:
            err = e
        _gather_or_raise(g, "mapping the peers' receive slots", err)
        # What every hop touches, looked up once: each slot's view, and
        # the addresses of the control messages.  CPU: cells[q][kind] is
        # q's cell in this rank's mailbox, peer_cells[q][kind] this
        # rank's in q's.  CUDA: counters in[q][kind] are q's in this
        # rank's memory (waited on), out[q][kind] this rank's in q's
        # (written), log_out[q] the address of this rank's row of q's
        # log.
        self._send_slots = {q: list(self._send[q]) for q in self._peers}
        self._recv_slots = {q: list(self._recv[q]) for q in self._peers}
        if self._cuda:
            self._cells = self._peer_cells = None
            self._counters_in = {q: [self._flags[q, k * LINE].data_ptr()
                                     for k in (_NOTIFY, _ACK)]
                                 for q in self._peers}
            self._counters_out = {
                q: [self._peer_flags[q][me, k * LINE].data_ptr()
                    for k in (_NOTIFY, _ACK)] for q in self._peers}
            self._log_out = {q: self._peer_box[q][me].data_ptr()
                             for q in self._peers}
        else:
            self._cells = {q: [self._box[q, kind] for kind in (_NOTIFY, _ACK)]
                           for q in self._peers}
            self._peer_cells = {q: [self._peer_box[q][me, kind]
                                    for kind in (_NOTIFY, _ACK)]
                                for q in self._peers}

    # -- control messages on the CPU -----------------------------------------

    def _publish(self, q: int, kind: int, values) -> None:
        """Write ``(seq, slot, bytes)`` into this rank's ``kind`` cell of
        ``q``'s mailbox, then raise its gen."""
        cell = self._peer_cells[q][kind]
        cell[1:] = torch.tensor(values, dtype=torch.int64)
        cell[0] = int(cell[0]) + 1
        traffic["control_messages"] += 1

    def _wait(self, q: int, kind: int, want: list) -> None:
        """Wait for message ``counter_target(want[0])`` in ``q``'s
        ``kind`` cell of this rank's mailbox and check that it is
        ``want`` (``(seq, slot, bytes)``)."""
        cell = self._cells[q][kind]
        gen = counter_target(want[0])
        if not _poll(lambda: int(cell[0]) >= gen,
                     time.monotonic() + self.timeout_s, longest=1e-3):
            raise late_error(self.name, q, self.group.global_rank(q), kind,
                             self.timeout_s, want[0])
        check_message(self.name, q, kind, cell.tolist(), want)

    # -- control messages on the card -----------------------------------------

    def _stream(self):
        """The current stream, after the last one the channel used (a
        channel driven from two streams keeps its order on the card)."""
        stream = torch.cuda.current_stream(self.device)
        handle = stream.cuda_stream
        last = self._last_stream
        if last is not None and last.cuda_stream != handle:
            ev = torch.cuda.Event()
            ev.record(last)
            stream.wait_event(ev)
        self._last_stream = self._streams[handle] = stream
        return handle

    def _call(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"cuda_ipc channel {self.name}: {what} "
                               f"failed with error {rc}")

    def _wait_on_card(self, stream: int, addr: int, value: int,
                      wait: tuple) -> None:
        """Enqueue on ``stream`` a wait on the card until the counter at
        ``addr`` reaches ``value``, for ``wait`` = ``(q, kind, seq)``."""
        self._call(self._lib.ipc_wait(stream, addr, value,
                                      self._passed_addr, self.waits + 1),
                   f"the wait for {_KIND[wait[1]]} {wait[2]} of rank "
                   f"{wait[0]}")
        traffic["device_waits"] += 1
        self.waits += 1
        self._waits.append(wait)
        self._wait_at.append(next(_waits_enqueued))

    def sync(self) -> None:
        """Wait until the streams this rank used for the channel since
        the last sync have run everything it enqueued, polling with the
        channel's deadline, then check the byte count of every payload
        taken since.  Raises :func:`late_error` naming the peer that
        lags (the counters read on the card) when the deadline passes,
        and :func:`check_message`'s error for a payload of other bytes
        than expected.  Nothing to do on the CPU, whose hops wait."""
        if not self._cuda:
            return
        events = []
        for stream in self._streams.values():
            ev = torch.cuda.Event()
            ev.record(stream)
            events.append(ev)
        if events:
            deadline = time.monotonic() + self.timeout_s
            with _wait_span("cuda_ipc.sync"):
                for ev in events:
                    if not _poll(ev.query, deadline):
                        raise self._late()
        self._streams.clear()
        self._last_stream = None
        self._hops = 0
        self._waits, self._wait_at, self._waited0 = [], [], self.waits
        pending, self._pending = self._pending, []
        if pending:
            qs, seqs, nbytes = zip(*pending)
            got = self._box[list(qs), [s % LOG for s in seqs]].tolist()
            for q, seq, n, (gseq, gbytes) in zip(qs, seqs, nbytes, got):
                check_message(self.name, q, _NOTIFY,
                              [counter_target(gseq), gseq, gseq % SLOTS,
                               gbytes], [seq, seq % SLOTS, n])

    def _not_passed(self):
        """``(number among the process's waits, wait)`` of this
        channel's first wait the card has not passed, or None."""
        passed = self._passed[self._cell] - self._waited0
        wait = lagging(self._waits, passed)
        return None if wait is None else (self._wait_at[passed], wait)

    def _late(self) -> TimeoutError:
        """The error of a sync past its deadline: the first wait the card
        has not passed names the peer, read from host memory (a call into
        CUDA here, a copy or even a new stream, can queue behind the
        blocked stream).  Channels share streams, so this one's sync may
        wait behind another's wait: the first enqueued of every open
        channel's waits not passed is the one named."""
        chans = [self] + [c for c in _open_channels
                          if c is not self and c._cuda]
        late = []
        for ch in chans:
            first = ch._not_passed()
            if first is not None:
                late.append((*first, ch))
        if not late:
            return TimeoutError(
                f"cuda_ipc channel {self.name}: the card passed every wait "
                f"of this rank's hops but did not finish them in "
                f"{self.timeout_s} s")
        _, (q, kind, seq), ch = min(late, key=lambda x: x[0])
        return late_error(ch.name, q, ch.group.global_rank(q), kind,
                          self.timeout_s, seq)

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
        if self._cuda:
            stream = self._stream()
            bound = reuse_bound(seq)
            if bound:               # q has read the slot's last payload
                self._wait_on_card(stream, self._counters_in[q][_ACK],
                                   bound, (q, _ACK, seq - SLOTS))
        slot = self._send_slots[q][k]
        nbytes = 0
        for p, off in zip(parts, offsets):
            b = _as_bytes(p)
            slot[off:off + b.numel()].copy_(b)
            nbytes += b.numel()
        if self._cuda:
            self._call(self._lib.ipc_signal(
                stream, self._log_out[q] + 16 * (seq % LOG), seq, nbytes,
                self._counters_out[q][_NOTIFY], counter_target(seq)),
                "the notify")
            traffic["control_messages"] += 1
            self._hops += 1
        else:
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
        if self._cuda:
            stream = self._stream()
            self._wait_on_card(stream, self._counters_in[q][_NOTIFY],
                               counter_target(seq), (q, _NOTIFY, seq))
        else:
            with _wait_span("cuda_ipc.notify_wait"):
                self._wait(q, _NOTIFY, [seq, k, nbytes])
        slot = self._recv_slots[q][k]
        views = [slot[off:off + t.numel() * t.element_size()]
                 .view(t.dtype).reshape(t.shape)
                 for t, off in zip(like, offsets)]
        out = consume(*views)
        self._check_not_slot(out, slot)
        if self._cuda:
            self._call(self._lib.ipc_signal(
                stream, None, 0, 0, self._counters_out[q][_ACK],
                counter_target(seq)), "the acknowledgement")
            traffic["control_messages"] += 1
            self._pending.append((q, seq, nbytes))
            self._hops += 1
        else:
            self._publish(q, _ACK, (seq, 0, 0))
        self._taken[q] = seq + 1
        return out

    def finish(self, posted) -> None:
        """End a collective call.  On the CPU wait for the
        acknowledgement of what this rank posted to each of ``posted``
        (each peer has read it by then).  On the card wait for nothing,
        unless ``LOG // 4`` hops have passed since the last sync: then
        :meth:`sync` (which bounds the byte-count log's unchecked
        entries)."""
        if self._cuda:
            if self._hops >= LOG // 4:
                self.sync()
            return
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

    def _check_final(self) -> None:
        """After every rank has synced: each peer posted exactly what
        this rank took, and acknowledged everything it sent."""
        flags = self._flags.tolist()
        notify = {q: flags[q][0] for q in self._peers}
        ack = {q: flags[q][LINE] for q in self._peers}
        for q in self._peers:
            if notify[q] != self._taken[q] or ack[q] != self._sent[q]:
                raise RuntimeError(
                    f"cuda_ipc channel {self.name}: at close rank {q} had "
                    f"posted {notify[q]} payloads and acknowledged "
                    f"{ack[q]}; this rank took {self._taken[q]} and sent "
                    f"{self._sent[q]}")

    def close(self) -> None:
        """Collective: sync, check every counter's final value, unmap
        the peers' slots and counters on every rank, then free this
        rank's own."""
        if self.closed:
            return
        self.sync()
        self.closed = True
        dist.barrier(group=self.group.pg)
        if self._cuda:
            self._check_final()
        self._send = self._peer_box = self._peer_flags = None
        self._send_slots = self._peer_cells = self._counters_out = None
        dist.barrier(group=self.group.pg)
        # Every tensor from the slots' pool goes before the pool: one
        # still alive when the pool goes keeps its block out of the
        # allocator's reach.
        self._recv_slots = self._cells = self._box = None
        self._counters_in = self._passed = None
        if self._cuda:
            _free_cell(self._cell)
        self._recv = self._flags = self._pool = None
        if self._cuda:
            torch.cuda.ipc_collect()
        _open_channels.remove(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        # A failure inside the block leaves the channel as it is: its
        # close is collective and would wait on peers and on the card.
        if exc_type is None:
            self.close()


def sync_channels() -> None:
    """:meth:`IpcChannel.sync` every channel this process has open: the
    host's wait for the card's channel work, with its deadline.  A host
    wait for the card on a path that has channels (a device sync, a
    copy to the host) calls this first: a stream wait has no timeout of
    its own, so a peer that never posts would hang it."""
    for ch in list(_open_channels):
        ch.sync()


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
