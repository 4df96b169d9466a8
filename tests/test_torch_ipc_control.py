"""The ``cuda_ipc`` channel's sequence arithmetic, shared by its CPU path
and its waits on the card (``core/dist.py``), with no ranks (~3 s).

The card runs these functions' targets through ``csrc/mailbox.cu``;
here they are held to what a hop needs: the counter value each message
makes, the acknowledgement a slot waits for past ``SLOTS``, the byte
check's text, the peer a timeout names.  Then ``IpcChannel``'s CUDA
branch itself runs against a fake card: its control library, streams,
events and slots record what the channel enqueues, in order, as each
rank's stream of operations (waits on counters, slot copies, the
consumer's reads, counter writes), and the test plays those streams at
rates it picks.  Every payload must arrive intact and in order, no
stream may deadlock, the counters end at their final values, and the
host's sync must check the byte counts and name the peer a blocked
stream waits for.
"""
import collections
import ctypes
import re
import types

import pytest

from repro_torch.core import dist


@pytest.mark.parametrize("seq", [0, 1, 2, 7, 1023, 1024])
def test_counter_target_counts_messages_from_one(seq):
    assert dist.counter_target(seq) == seq + 1


@pytest.mark.parametrize("seq,want", [(0, 0), (1, 0), (2, 1), (3, 2),
                                      (9, 8)])
def test_reuse_bound_waits_for_the_slots_last_payload(seq, want):
    """Payload ``seq`` goes into slot ``seq % SLOTS``; the one before it
    there, ``seq - SLOTS``, must have been acknowledged: the ack count
    reaches its counter target."""
    assert dist.SLOTS == 2
    assert dist.reuse_bound(seq) == want
    if seq >= dist.SLOTS:
        assert want == dist.counter_target(seq - dist.SLOTS)


@pytest.mark.parametrize("got,want,text", [
    ([1, 0, 0, 12], [0, 0, 12], None),
    ([4, 3, 1, 8], [3, 1, 8], None),
    ([1, 0, 0, 8], [0, 0, 12],
     "rank 3 sent the notify [0, 0, 8] (message 1), expected (seq, slot, "
     "bytes) [0, 0, 12] (message 1)"),
    ([1, 7, 1, 12], [0, 0, 12],
     "rank 3 sent the notify [7, 1, 12] (message 1), expected (seq, slot, "
     "bytes) [0, 0, 12] (message 1)"),
    ([2, 1, 1, 12], [0, 0, 12], "(message 2)"),
])
def test_check_message_notify(got, want, text):
    if text is None:
        dist.check_message("data#0", 3, dist._NOTIFY, got, want)
        return
    with pytest.raises(RuntimeError) as e:
        dist.check_message("data#0", 3, dist._NOTIFY, got, want)
    assert str(e.value).startswith("cuda_ipc channel data#0: ")
    assert text in str(e.value)


@pytest.mark.parametrize("got,ok", [([3, 2, 0, 0], True),
                                    ([3, 1, 0, 0], False),
                                    ([2, 2, 0, 0], False)])
def test_check_message_acknowledgement(got, ok):
    if ok:
        dist.check_message("pod#2", 1, dist._ACK, got, [2])
        return
    with pytest.raises(RuntimeError, match=r"rank 1 acknowledged \[.\] "
                       r"\(message .\), expected payload 2 \(message 3\)"):
        dist.check_message("pod#2", 1, dist._ACK, got, [2])


@pytest.mark.parametrize("kind,what", [(0, "notify"),
                                       (1, "acknowledgement")])
def test_late_error_names_the_peer(kind, what):
    e = dist.late_error("data#4", 2, 6, kind, 300.0, 17)
    assert isinstance(e, TimeoutError)
    assert str(e) == (f"cuda_ipc channel data#4: no {what} from rank 2 "
                      f"(global rank 6) in 300.0 s; expected seq 17")


WAITS = [(1, 0, 0), (2, 0, 0), (1, 1, 0), (1, 0, 1), (2, 1, 3)]


@pytest.mark.parametrize("passed,want", [
    (0, (1, 0, 0)),                 # rank 1's first notify
    (2, (1, 1, 0)),                 # rank 1's acknowledgement of payload 0
    (4, (2, 1, 3)),
    (5, None),                      # every wait passed
])
def test_lagging_names_the_first_wait_not_passed(passed, want):
    """The card runs a stream's waits in order, so the first it has not
    passed is the one it is blocked on."""
    assert dist.lagging(WAITS, passed) == want
    if want is not None:
        q, kind, seq = want
        assert f"no {dist._KIND[kind]} from rank {q} " in str(
            dist.late_error("data#0", q, q, kind, 1.0, seq))


@pytest.mark.parametrize("support,rc,text", [
    (0, 0, "has no 64-bit stream memory operations "
           "(CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS is 0)"),
    (1, 3, "could not be opened on cuda:5 (error 3)"),
])
def test_a_card_without_stream_memory_operations_raises(monkeypatch, support,
                                                         rc, text):
    """No host fallback: the channel's control library refuses a card
    whose driver lacks the operations its waits are made of."""
    import torch
    from repro_torch.kernels import backend

    def ipc_open(index, out):
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int))[0] = support
        return rc

    def unused(*args):
        raise AssertionError("called before the card was accepted")

    lib = types.SimpleNamespace(ipc_open=ipc_open, ipc_wait=unused,
                                ipc_signal=unused, ipc_host_cells=unused)
    monkeypatch.setattr(backend, "load", lambda name: lib)
    monkeypatch.setattr(dist, "_CONTROL", {})
    with pytest.raises(RuntimeError) as e:
        dist._control_lib(torch.device("cuda", 5))
    assert text in str(e.value)
    assert 5 not in dist._CONTROL


# -- IpcChannel's CUDA branch on a fake card -----------------------------------

def _load(addr):
    return ctypes.c_int64.from_address(addr).value


def _store(addr, value):
    ctypes.c_int64.from_address(addr).value = value


class _Stream:
    def __init__(self, card, handle):
        self.card, self.cuda_stream = card, handle

    def wait_event(self, ev):
        self.card.queues[self.cuda_stream].append(("event", ev))


class _Event:
    """``torch.cuda.Event``: done once its stream has run every
    operation enqueued before ``record``."""

    def __init__(self, card):
        self.card, self.at = card, None

    def record(self, stream):
        self.at = (stream.cuda_stream,
                   len(self.card.queues[stream.cuda_stream]))

    def query(self):
        handle, n = self.at
        return self.card.done[handle] >= n


class _Range:
    """Bytes ``lo:hi`` of a fake slot, as the channel slices and views
    them; a copy into it or a read of it is enqueued on the current
    stream."""

    def __init__(self, card, key, lo, hi, dtype=None, shape=None):
        self.card, self.key, self.lo, self.hi = card, key, lo, hi
        self.dtype, self.shape = dtype, shape

    def copy_(self, src):
        self.card.enqueue(("copy", self, src.clone()))

    def view(self, dtype):
        return _Range(self.card, self.key, self.lo, self.hi, dtype,
                      self.shape)

    def reshape(self, shape):
        return _Range(self.card, self.key, self.lo, self.hi, self.dtype,
                      tuple(shape))

    def bytes(self):
        return self.card.slot(self.key)[self.lo:self.hi]


class _Slot:
    def __init__(self, card, key):
        self.card, self.key = card, key

    def __getitem__(self, sl):
        return _Range(self.card, self.key, sl.start, sl.stop)

    def untyped_storage(self):
        return types.SimpleNamespace(data_ptr=lambda: id(self))


class _Card:
    """One card shared by ``world`` ranks, each with the channels the
    test opens: the counters, the byte-count logs and the pinned cells
    are host memory here, which the fake control library reads and
    writes at the addresses the channel hands it (as ``mailbox.cu``
    does on the card); every other operation is recorded on its
    stream's queue and runs in :meth:`run`."""

    def __init__(self, world=2, slot_bytes=64):
        self.world, self.slot_bytes = world, slot_bytes
        self.queues = collections.defaultdict(list)
        self.done = collections.defaultdict(int)
        self.slots = {}
        self.current = 0              # the stream handle the host is on
        self.keep = []                # the memory the addresses point at
        self.lib = types.SimpleNamespace(ipc_wait=self._wait,
                                         ipc_signal=self._signal)

    # the host's side
    def stream(self, handle=None):
        return _Stream(self, self.current if handle is None else handle)

    def enqueue(self, op):
        self.queues[self.current].append(op)

    def slot(self, key):
        import torch
        return self.slots.setdefault(
            key, torch.zeros(self.slot_bytes, dtype=torch.uint8))

    def _wait(self, stream, addr, value, done, count):
        self.queues[stream].append(("wait", addr, value, done, count))
        return 0

    def _signal(self, stream, log, seq, nbytes, addr, value):
        if log:                     # the host's store, before the enqueue
            _store(log + 8, nbytes)
            _store(log, seq)
        self.queues[stream].append(("write", addr, value))
        return 0

    def open(self, name="data#0", timeout_s=1.0):
        """One channel per rank, laid out as ``IpcChannel._register``
        lays out its CUDA branch."""
        import torch
        me_flags = [torch.zeros((self.world, 2 * dist.LINE),
                                dtype=torch.int64) for _ in range(self.world)]
        boxes = [torch.zeros((self.world, dist.LOG, 2), dtype=torch.int64)
                 for _ in range(self.world)]
        chans = []
        for me in range(self.world):
            peers = [q for q in range(self.world) if q != me]
            ch = object.__new__(dist.IpcChannel)
            ch.device, ch._cuda, ch.closed = torch.device("cpu"), True, False
            ch.slot_bytes, ch.timeout_s, ch.name = (self.slot_bytes,
                                                    timeout_s, name)
            ch.group = types.SimpleNamespace(
                rank=me, size=self.world, global_rank=lambda q: 10 + q)
            ch._peers = peers
            ch._sent = {q: 0 for q in peers}
            ch._taken = {q: 0 for q in peers}
            ch._streams, ch._last_stream, ch._pending = {}, None, []
            ch._hops, ch._waits, ch._wait_at = 0, [], []
            ch._waited0 = ch.waits = 0
            ch._lib = self.lib
            passed = (ctypes.c_int64 * 1)()
            self.keep.append(passed)
            ch._cell, ch._passed = 0, passed
            ch._passed_addr = ctypes.addressof(passed)
            ch._flags, ch._box = me_flags[me], boxes[me]
            ch._send_slots = {q: [_Slot(self, (name, q, me, k))
                                  for k in range(dist.SLOTS)] for q in peers}
            ch._recv_slots = {q: [_Slot(self, (name, me, q, k))
                                  for k in range(dist.SLOTS)] for q in peers}
            ch._counters_in = {q: [me_flags[me][q, k * dist.LINE].data_ptr()
                                   for k in (dist._NOTIFY, dist._ACK)]
                               for q in peers}
            ch._counters_out = {q: [me_flags[q][me, k * dist.LINE].data_ptr()
                                    for k in (dist._NOTIFY, dist._ACK)]
                                for q in peers}
            ch._log_out = {q: boxes[q][me].data_ptr() for q in peers}
            chans.append(ch)
        self.keep += me_flags + boxes
        dist._open_channels.extend(chans)
        return chans

    # the card's side
    def _step(self, handle):
        """Run the next operation of ``handle``'s stream; False when it
        is blocked or empty."""
        q = self.queues[handle]
        i = self.done[handle]
        if i == len(q):
            return False
        op = q[i]
        if op[0] == "wait":
            _, addr, value, done, count = op
            if _load(addr) < value:
                return False
            _store(done, count)
        elif op[0] == "event" and not op[1].query():
            return False
        elif op[0] == "write":
            _, addr, value = op
            assert value == _load(addr) + 1, "a skipped message"
            _store(addr, value)
        elif op[0] == "copy":
            _, rng, src = op
            rng.bytes()[:] = src
        elif op[0] == "read":
            _, views, sink = op
            sink.append([v.bytes().clone().view(v.dtype).reshape(v.shape)
                         for v in views])
        self.done[handle] = i + 1
        return True

    def run(self, order, stop_when_blocked=False):
        """Step the streams ``order`` names in turn, a blocked one
        skipped, until all are empty; when every stream is blocked,
        return or (a deadlock) raise."""
        while any(self.done[h] < len(self.queues[h]) for h in order):
            if not any([self._step(h) for h in order]):
                if stop_when_blocked:
                    return
                raise AssertionError(f"deadlock: {dict(self.queues)}")


@pytest.fixture
def card(monkeypatch):
    import torch
    c = _Card()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: c.stream())
    monkeypatch.setattr(torch.cuda, "Event", lambda: _Event(c))
    monkeypatch.setattr(dist, "_open_channels", [])
    return c


def _reader(card, sink):
    """A consumer that reads the slot on the stream (as a kernel would)
    and returns nothing of it."""
    def consume(*views):
        card.enqueue(("read", views, sink))
        return []
    return consume


def _payload(s, i, n=4):
    import torch
    return torch.full((n,), float(100 * s + i))


def _hop(card, chans, i, sinks):
    """One ring exchange between two ranks: each posts to the other,
    takes from it and finishes, as ``ppermute_parts`` does; the hosts
    enqueue everything at once (no host wait)."""
    for me, ch in enumerate(chans):
        card.current = me
        peer = 1 - me
        ch.post(peer, [_payload(me, i)])
        ch.take(peer, [_payload(peer, i)], _reader(card, sinks[me]))
        ch.finish([peer])


@pytest.mark.parametrize("hops", [1, 2, 3, 7, 20])
@pytest.mark.parametrize("order", [(0, 1), (1, 0), (0, 0, 0, 1),
                                   (1, 1, 1, 0)])
def test_device_waits_deliver_every_payload_past_slots(card, hops, order):
    """``hops`` ring exchanges between two ranks' channels, the streams
    advancing at other rates: each take reads its own payload, never one
    that a later post overwrote, the counters end at their final values,
    and each rank's sync finds every byte count as posted."""
    import torch
    chans = card.open()
    sinks = ([], [])
    for i in range(hops):
        _hop(card, chans, i, sinks)
    card.run(order)
    for me, ch in enumerate(chans):
        got = [v[0] for v in sinks[me]]
        assert len(got) == hops
        for i, t in enumerate(got):
            assert torch.equal(t, _payload(1 - me, i))
        # a notify wait per take, a slot wait from the third post on
        assert ch.waits == hops + max(hops - dist.SLOTS, 0)
    for me, ch in enumerate(chans):
        card.current = me
        ch.sync()
        ch._check_final()


@pytest.mark.parametrize("hops", [3, 8])
def test_a_sender_ahead_of_its_reader_waits_for_the_slot(card, hops):
    """One rank posts ``hops`` payloads before its peer takes any: its
    stream stops at the third post until the peer's stream has read the
    first, so no slot is overwritten unread."""
    import torch
    chans = card.open()
    for i in range(hops):
        chans[0].post(1, [_payload(0, i)])
        chans[0].finish([1])
    card.run((0,), stop_when_blocked=True)     # only the sender moves
    assert _load(chans[1]._counters_in[0][dist._NOTIFY]) == dist.SLOTS
    assert card.done[0] < len(card.queues[0])
    sink = []
    card.current = 1
    for i in range(hops):
        chans[1].take(0, [_payload(0, i)], _reader(card, sink))
    card.run((0, 1))
    assert [v[0].tolist() for v in sink] == [_payload(0, i).tolist()
                                             for i in range(hops)]


@pytest.mark.parametrize("order", [(0, 1), (0, 0, 0, 1), (0,) * 8 + (1,)])
def test_a_fast_sender_never_overwrites_an_unread_slot(card, order):
    """The reader acknowledges a payload only after its read: a sender
    whose stream runs several operations to each of the reader's posts
    into a slot only once the payload before it there has been read."""
    hops = 6
    chans = card.open()
    for i in range(hops):
        chans[0].post(1, [_payload(0, i)])
        chans[0].finish([1])
    sink = []
    card.current = 1
    for i in range(hops):
        chans[1].take(0, [_payload(0, i)], _reader(card, sink))
    card.run(order)
    assert [v[0].tolist() for v in sink] == [_payload(0, i).tolist()
                                             for i in range(hops)]


def test_sync_checks_each_payloads_byte_count(card):
    """Rank 1 posts 8 bytes where rank 0 takes 12: the hop runs on the
    card, and rank 0's next sync raises the notify check's text."""
    chans = card.open()
    card.current = 1
    chans[1].post(0, [_payload(1, 0, n=2)])
    card.current = 0
    chans[0].take(1, [_payload(1, 0, n=3)], _reader(card, []))
    card.run((0, 1))
    with pytest.raises(RuntimeError, match=re.escape(
            "cuda_ipc channel data#0: rank 1 sent the notify [0, 0, 8] "
            "(message 1), expected (seq, slot, bytes) [0, 0, 12] "
            "(message 1)")):
        chans[0].sync()


@pytest.mark.parametrize("case", ["notify", "acknowledgement",
                                  "another channel"])
def test_a_sync_past_its_deadline_names_the_peer_it_waits_for(card, case):
    """Rank 0's stream blocks on a wait for rank 1, which never writes:
    the sync polls to its deadline and names rank 1, the channel and the
    sequence number from the waits the card passed.  Channels share the
    stream, so a channel whose own waits all passed names the other
    channel's wait it is stuck behind."""
    a = card.open("data#0", timeout_s=0.05)
    b = card.open("data#1", timeout_s=0.05)
    card.current = 1                    # a hop on b first: its wait passes
    b[1].post(0, [_payload(1, 0)])
    card.current = 0
    b[0].take(1, [_payload(1, 0)], _reader(card, []))
    if case == "acknowledgement":
        for i in range(dist.SLOTS + 1):     # the third post waits
            a[0].post(1, [_payload(0, i)])
        want = "no acknowledgement from rank 1 (global rank 11) in " \
               "0.05 s; expected seq 0"
    else:
        a[0].take(1, [_payload(1, 0)], _reader(card, []))
        want = "no notify from rank 1 (global rank 11) in 0.05 s; " \
               "expected seq 0"
    card.run((0, 1), stop_when_blocked=True)
    assert b[0]._not_passed() is None
    syncing = b[0] if case == "another channel" else a[0]
    with pytest.raises(TimeoutError) as e:
        syncing.sync()
    assert str(e.value) == f"cuda_ipc channel data#0: {want}"


def test_a_channel_driven_from_two_streams_keeps_its_order(card):
    """Rank 0 posts on one stream, then on another: the second stream
    waits for the first's work before its own, so the slot copies and
    notifies land in order even when the second stream runs first."""
    import torch
    chans = card.open()
    chans[0].post(1, [_payload(0, 0)])
    card.current = 10                   # a second stream of rank 0
    chans[0].post(1, [_payload(0, 1)])
    assert card.queues[10][0][0] == "event"
    sink = []
    card.current = 1
    for i in range(2):
        chans[1].take(0, [_payload(0, i)], _reader(card, sink))
    card.run((10, 1, 0))
    assert [v[0].tolist() for v in sink] == [_payload(0, i).tolist()
                                             for i in range(2)]
    assert set(chans[0]._streams) == {0, 10}
    card.current = 0
    chans[0].sync()
    card.current = 1
    chans[1].sync()
    assert chans[0]._streams == {}
