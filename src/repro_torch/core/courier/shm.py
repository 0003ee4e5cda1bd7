"""Shared-memory ring-buffer channel for same-host courier traffic.

Two nodes the process launcher placed on one host still paid the full gRPC
stack for every call (~2000x the in-process cost for a ping — see
BENCH_rpc.json). This module moves framed courier messages between
same-host processes over ``multiprocessing.shared_memory`` instead:

* **Ring** — one SPSC byte ring per direction. The writer owns ``wpos``,
  the reader owns ``rpos`` (each on its own cache line, published after
  the payload), so neither side ever takes a cross-process lock on the
  data path. Records are length-prefixed and contiguous; a record that
  would straddle the wrap point is preceded by a pad record both sides
  skip deterministically.
* **Slot pool** — a message larger than ``SPILL_THRESHOLD`` is
  scatter-gathered (``serialization.write_framed_into``) into one slot
  of a per-direction *slot pool* side segment (``SLOT_COUNT`` fixed-
  offset slots, free map in the segment header) and only a tiny
  reference record enters the control ring, so the ring stays small
  while 8 MiB tensors move at memcpy speed. The pool is created lazily,
  reused for the connection's lifetime (segment creation and first-touch
  page faults cost milliseconds on the kernels we deploy on), and
  regrown under a versioned name when a bigger message arrives; slots
  sit at *fixed* offsets — cycling a multi-MiB ring through the cache
  measures ~3x slower than rewriting a few hot regions.
* **Zero-copy receive** — the reader decodes a slot *in place*
  (``serialization.loads_owned``): decoded arrays are read-only views
  aliasing the slot, pinned by a :class:`SlotLease`. The slot returns to
  the pool when the decoded message is garbage-collected (or the lease
  explicitly released) — **not** when the receive returns — so the
  receive path never copies the payload, and with ``SLOT_COUNT`` slots
  per direction, pipelined large messages overlap instead of
  serializing on one slot. A consumer that retains a decoded tensor
  long-term must ``np.copy`` it (or ``serialization.materialize`` the
  message) or it starves the sender's pool.
* **Doorbell** — waiting sides use an adaptive spin-then-micro-sleep loop
  (a portable stand-in for a futex: hot peers rendezvous in microseconds,
  idle peers cost ~0 CPU). Position loads/stores are 8-byte aligned, so
  they are single movs on x86-64/arm64 — published last, read first.
* **Rendezvous** — a server advertises under
  ``$TMPDIR/courier-shm/<name>/listener.json``; a client creates the two
  rings, drops a ``<conn>.connect`` file, and waits for the listener's
  HELLO record. Liveness is pid-based: a stale directory left by a
  crashed server is detected immediately (``probe`` -> "stale") so
  callers can fall back to gRPC instead of deadlocking.

Record layout (little-endian)::

    size:u32 | kind:u32 | req_id:u64 | body[size - 16]

``size == 0`` marks a pad record (skip to the wrap point). The body is a
standard framed serialization message, or a slot-pool reference::

    \xc5\x03 | name_len:u16 | segment_name | slot:u32 | total:u64
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import socket
import struct
import tempfile
import threading
import time
import uuid
from concurrent import futures
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Callable, Optional

from repro_torch.core.courier import serialization as ser

# ---- tunables (module-level so tests/benchmarks can shrink them) ------------

RING_CAPACITY = 1 << 20        # per-direction control-ring data bytes
SPILL_THRESHOLD = 96 * 1024    # messages above this go to the slot pool
SLOT_COUNT = 4                 # fixed-offset slots per pool (per direction)
SLOT_HEADROOM = 1.5            # pool slots are sized to msg_size * this
CONNECT_WAIT_S = 5.0           # how long a client waits for the listener
ACCEPT_WAIT_S = 5.0            # how long a client waits for HELLO
_POLL_ACCEPT_S = 0.01          # listener connect-dir poll interval

_POOL_GROW_GRACE_S = 0.02      # full-pool wait before expanding the pool

# _doorbell_wait backoff schedule (module-level so tests can shrink it).
_SPIN_HOT = 1600               # hot-phase checks (sched_yield every 4th)
_SPIN_MICRO = 6400             # then micro-sleeps until this many checks
_SLEEP_MICRO_S = 0.00002
_SLEEP_IDLE_S = 0.0002

# ---- record kinds ------------------------------------------------------------

KIND_HELLO = 0
KIND_CALL = 1
KIND_BATCH = 2
KIND_REPLY = 3
KIND_BATCH_REPLY = 4
KIND_CLOSE = 5

_REC = struct.Struct("<IIQ")       # size (incl. header), kind, req_id
_REF_MAGIC = b"\xc5\x03"           # pool reference: namelen|name|slot|total
_REF_NAME = struct.Struct("<H")    # segment-name length
_REF_TAIL = struct.Struct("<IQ")   # slot index, framed-message length

# Ring segment header: wpos and rpos on separate cache lines; one closed
# byte per side so neither performs a read-modify-write on shared state.
_WPOS_OFF = 0
_RPOS_OFF = 64
_WCLOSED_OFF = 128
_RCLOSED_OFF = 129
_DATA_OFF = 192
_POS = struct.Struct("<Q")

# Slot-pool segment header (see SlotPool): slot count, slot size, a
# reader-closed byte, then one state byte per slot (0 free / 1 leased).
# Slot data starts page-aligned so slots never share a page with header
# state the two sides poll.
_PH_NSLOTS = struct.Struct("<I")   # at offset 0
_PH_SLOTSZ_OFF = 8                 # u64 via _POS
_PH_RCLOSED_OFF = 16
_PH_STATES_OFF = 64
_POOL_DATA_OFF = 4096
_SLOT_ALIGN = 4096


class RingClosed(ConnectionError):
    """The peer closed its end of the ring (or went away)."""


class DecodeFailure:
    """A message that arrived intact but failed to unpickle; carries the
    decode exception while preserving reply correlation."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ShmConnectError(ConnectionError):
    """Could not establish a shared-memory connection (caller may fall
    back to another transport)."""


def supported() -> bool:
    """Shared-memory transport is POSIX-only (named segments + pid probes)."""
    return os.name == "posix"


def _untrack(shm: shared_memory.SharedMemory) -> None:
    # Python <=3.12 registers every attach with the resource tracker, which
    # then unlinks segments owned by *other* processes at exit (bpo-39959).
    # We manage unlink ourselves, so take the segment out of the tracker.
    with contextlib.suppress(Exception):
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001


def _unlink_quiet(name: str) -> None:
    # shm_unlink without SharedMemory.unlink()'s resource-tracker
    # unregister (we already untracked; a second unregister raises in the
    # tracker daemon). ``name`` is the public segment name (no slash).
    try:
        import _posixshmem  # stdlib backend of shared_memory on POSIX
        with contextlib.suppress(FileNotFoundError):
            _posixshmem.shm_unlink("/" + name.lstrip("/"))
    except ImportError:  # pragma: no cover - non-POSIX
        with contextlib.suppress(Exception):
            shared_memory.SharedMemory(name=name).unlink()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _doorbell_wait(ready: Callable[[], bool], *,
                   deadline: Optional[float],
                   give_up: Callable[[], Optional[BaseException]]) -> bool:
    """Adaptive wait: poll with periodic yields, then micro-sleeps.

    The hot phase checks ``ready`` back-to-back and releases the GIL with
    ``time.sleep(0)`` (sched_yield) every 4th check. Yielding on *every*
    check paid a syscall per sub-microsecond poll and put the shm ping at
    ~240us; polling between yields brings hot rendezvous down to the
    check granularity itself while still never holding the GIL longer
    than a few checks (a pure Python spin would hold it for a full switch
    interval, ~5ms, convoying the very thread that would satisfy the wait
    when sender and waiter share a process). After the hot phase come
    20us micro-sleeps, then 200us naps so long-idle waiters cost ~0 CPU.
    Returns False on deadline; raises whatever ``give_up`` supplies
    (peer-closed / peer-dead detection, throttled — it may involve a
    pid-probe syscall)."""
    spins = 0
    while not ready():
        if spins % 128 == 0:
            exc = give_up()
            if exc is not None:
                raise exc
            if deadline is not None and time.monotonic() >= deadline:
                return False
        spins += 1
        if spins < _SPIN_HOT:
            if spins % 4 == 0:
                time.sleep(0)
        elif spins < _SPIN_MICRO:
            time.sleep(_SLEEP_MICRO_S)
        else:
            time.sleep(_SLEEP_IDLE_S)
    return True


class Ring:
    """Single-producer single-consumer byte ring over one shm segment.

    Positions are monotonic u64s; the writer publishes ``wpos`` only after
    the record bytes are in place, the reader publishes ``rpos`` only after
    copying a record out, so each position has exactly one writer and the
    data path needs no cross-process lock. In-process concurrency (several
    client threads sending) is serialized by ``_wlock``.
    """

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self._cap = shm.size - _DATA_OFF
        self._owner = owner
        self._wlock = threading.Lock()
        self._released = False

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, name: str, capacity: int = RING_CAPACITY) -> "Ring":
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=capacity + _DATA_OFF)
        _untrack(shm)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "Ring":
        shm = shared_memory.SharedMemory(name=name)
        _untrack(shm)
        return cls(shm, owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    # -- header accessors ----------------------------------------------------
    def _load(self, off: int) -> int:
        return _POS.unpack_from(self._buf, off)[0]

    def _store(self, off: int, value: int) -> None:
        _POS.pack_into(self._buf, off, value)

    def close_write(self) -> None:
        self._buf[_WCLOSED_OFF] = 1

    def close_read(self) -> None:
        self._buf[_RCLOSED_OFF] = 1

    @property
    def writer_closed(self) -> bool:
        return self._buf[_WCLOSED_OFF] != 0

    @property
    def reader_closed(self) -> bool:
        return self._buf[_RCLOSED_OFF] != 0

    def has_backlog(self) -> bool:
        """More records waiting? (reader-side heuristic; racy by nature)"""
        return self._load(_WPOS_OFF) != self._load(_RPOS_OFF)

    # -- data path -----------------------------------------------------------
    def write(self, kind: int, req_id: int, chunks,
              timeout: Optional[float] = None,
              give_up: Optional[Callable[[], Optional[BaseException]]] = None
              ) -> None:
        """Gather ``chunks`` into one contiguous record. Blocks while the
        ring is full; raises :class:`RingClosed` if the reader is gone."""
        views = [memoryview(c).cast("B") for c in chunks]
        total = _REC.size + sum(v.nbytes for v in views)
        if total > self._cap:
            raise ValueError(
                f"record of {total} bytes exceeds ring capacity {self._cap} "
                "(spill threshold misconfigured?)")
        deadline = None if timeout is None else time.monotonic() + timeout

        def _give_up():
            if self.reader_closed:
                return RingClosed("ring reader closed")
            return give_up() if give_up is not None else None

        with self._wlock:
            wpos = self._load(_WPOS_OFF)
            while True:
                off = wpos % self._cap
                rem = self._cap - off
                # Bytes needed *now*: the record, plus the tail bytes a pad
                # (or implicit skip) would consume first.
                need = rem + total if rem < total else total
                if not _doorbell_wait(
                        lambda: self._cap - (wpos - self._load(_RPOS_OFF))
                        >= need,
                        deadline=deadline, give_up=_give_up):
                    raise TimeoutError("ring full")
                if rem < _REC.size:
                    # Tail too small even for a header: both sides skip it.
                    wpos += rem
                    self._store(_WPOS_OFF, wpos)
                    continue
                if rem < total:
                    # Pad record: reader jumps to the wrap point.
                    _REC.pack_into(self._buf, _DATA_OFF + off, 0, 0, 0)
                    wpos += rem
                    self._store(_WPOS_OFF, wpos)
                    continue
                pos = _DATA_OFF + off
                _REC.pack_into(self._buf, pos, total, kind, req_id)
                pos += _REC.size
                for v in views:
                    ser.copy_into(self._buf, pos, v)
                    pos += v.nbytes
                # Publish *after* the payload is in place.
                self._store(_WPOS_OFF, wpos + total)
                return

    def read(self, timeout: Optional[float] = None,
             give_up: Optional[Callable[[], Optional[BaseException]]] = None
             ) -> Optional[tuple[int, int, bytes]]:
        """Pop one record as ``(kind, req_id, body)``; the body is copied
        out so ring space recycles immediately. ``None`` on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def _give_up():
            if self.writer_closed and self._load(_WPOS_OFF) == rpos:
                return RingClosed("ring writer closed")
            return give_up() if give_up is not None else None

        rpos = self._load(_RPOS_OFF)
        while True:
            if not _doorbell_wait(lambda: self._load(_WPOS_OFF) != rpos,
                                  deadline=deadline, give_up=_give_up):
                return None
            off = rpos % self._cap
            rem = self._cap - off
            if rem < _REC.size:
                rpos += rem
                self._store(_RPOS_OFF, rpos)
                continue
            size, kind, req_id = _REC.unpack_from(self._buf, _DATA_OFF + off)
            if size == 0:  # pad
                rpos += rem
                self._store(_RPOS_OFF, rpos)
                continue
            start = _DATA_OFF + off + _REC.size
            body = ser.read_copy(self._buf, start, size - _REC.size)
            rpos += size
            self._store(_RPOS_OFF, rpos)
            return kind, req_id, body

    # -- lifecycle -----------------------------------------------------------
    def release(self, unlink: bool = False) -> None:
        """Drop our mapping (and the name, if ``unlink``). Idempotent."""
        if self._released:
            return
        self._released = True
        self._buf = None  # release the exported memoryview before close()
        name = self._shm.name
        with contextlib.suppress(Exception):
            self._shm.close()
        if unlink:
            _unlink_quiet(name)


class SlotLease:
    """Pins one :class:`SlotPool` slot under a decoded message.

    ``serialization.loads_owned`` threads the lease beneath every decoded
    array, so the slot returns to the pool exactly when the consumer
    drops the decoded object graph (CPython refcounting makes that
    prompt) — or earlier, via an explicit :meth:`release`. Idempotent;
    ``__del__`` is the GC fallback.
    """

    __slots__ = ("_pool", "_index", "_lock", "__weakref__")

    def __init__(self, pool: "SlotPool", index: int):
        self._pool = pool
        self._index = index
        # Leases release from arbitrary threads (GC of the decoded graph,
        # explicit release); the swap below must not double-free the slot.
        self._lock = threading.Lock()

    @property
    def released(self) -> bool:
        return self._pool is None

    def release(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool._release_slot(self._index)  # noqa: SLF001 - by design

    def __del__(self):
        try:
            self.release()
        except Exception:  # interpreter shutdown: globals may be gone
            pass


class SlotPool:
    """N fixed-offset one-message slots over one shm segment, with a
    header-tracked free map and a lease-based free protocol.

    Each state byte has exactly one writer per transition: the segment
    *writer* claims a free slot (0 -> 1, under the channel send lock),
    gathers the message into it, and publishes the control-ring
    reference only afterwards, so the reader never sees a half-written
    slot. The *reader* decodes the slot in place and returns it
    (1 -> 0) when the decoded message's :class:`SlotLease` is released —
    by GC of the object graph, not by the receive call — which is what
    makes the receive path zero-copy and lets ``SLOT_COUNT`` large
    messages be in flight per direction at once.

    The segment name is unlinked eagerly on :meth:`release`; the mapping
    itself is dropped only when the last outstanding lease dies, so a
    decoded view retained past transport close stays valid (POSIX keeps
    unlinked memory alive until the final ``munmap``).
    """

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self._name = shm.name
        self._owner = owner
        self.nslots = _PH_NSLOTS.unpack_from(shm.buf, 0)[0]
        self.slot_size = _POS.unpack_from(shm.buf, _PH_SLOTSZ_OFF)[0]
        self._lock = threading.Lock()  # guards lease count + close
        self._outstanding = 0
        self._released = False
        self._close_deferred = False

    @classmethod
    def create(cls, name: str, slot_size: int,
               nslots: Optional[int] = None) -> "SlotPool":
        nslots = SLOT_COUNT if nslots is None else nslots
        slot_size = -(-slot_size // _SLOT_ALIGN) * _SLOT_ALIGN
        shm = shared_memory.SharedMemory(
            name=name, create=True,
            size=_POOL_DATA_OFF + nslots * slot_size)
        _untrack(shm)
        _PH_NSLOTS.pack_into(shm.buf, 0, nslots)
        _POS.pack_into(shm.buf, _PH_SLOTSZ_OFF, slot_size)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "SlotPool":
        shm = shared_memory.SharedMemory(name=name)
        _untrack(shm)
        return cls(shm, owner=False)

    @property
    def name(self) -> str:
        return self._name

    def _data_off(self, index: int) -> int:
        return _POOL_DATA_OFF + index * self.slot_size

    @property
    def all_free(self) -> bool:
        buf = self._buf
        return buf is not None and all(
            buf[_PH_STATES_OFF + i] == 0 for i in range(self.nslots))

    # -- writer side ---------------------------------------------------------
    def acquire(self, timeout: Optional[float] = None,
                give_up: Optional[Callable] = None) -> int:
        """Claim a free slot (0 -> 1); blocks while all are leased by the
        consumer. Caller must serialize acquires (the channel send lock)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        buf = self._buf

        def _any_free():
            return any(buf[_PH_STATES_OFF + i] == 0
                       for i in range(self.nslots))

        def _give_up():
            if buf[_PH_RCLOSED_OFF] != 0:
                return RingClosed("slot pool reader closed")
            return give_up() if give_up is not None else None

        while True:
            for i in range(self.nslots):
                if buf[_PH_STATES_OFF + i] == 0:
                    buf[_PH_STATES_OFF + i] = 1
                    return i
            if not _doorbell_wait(_any_free, deadline=deadline,
                                  give_up=_give_up):
                raise TimeoutError(
                    "slot pool exhausted (all slots leased by the "
                    "consumer — long-retained decoded messages must be "
                    "copied, see courier/README.md)")

    def write_frames_at(self, index: int, frames) -> None:
        off = self._data_off(index)
        ser.write_framed_into(
            memoryview(self._buf)[off:off + self.slot_size], frames)

    def abandon(self, index: int) -> None:
        """Roll back an acquire whose control-ring reference was never
        emitted (the reader cannot have seen the slot)."""
        self._buf[_PH_STATES_OFF + index] = 0

    # -- reader side ---------------------------------------------------------
    def view(self, index: int, total: int) -> memoryview:
        """Writable view of one message in place (writable so the decode
        can pin the lease — see ``serialization.loads_owned``)."""
        off = self._data_off(index)
        return memoryview(self._buf)[off:off + total]

    def lease(self, index: int) -> SlotLease:
        with self._lock:
            self._outstanding += 1
        return SlotLease(self, index)

    def consume_copy(self, index: int, total: int):
        """PR-2 style copy-out receive: copy the message into fresh
        memory and free the slot immediately (the A/B baseline arm)."""
        data = ser.read_copy(self._buf, self._data_off(index), total)
        self._buf[_PH_STATES_OFF + index] = 0
        return data

    def close_read(self) -> None:
        with contextlib.suppress(Exception):
            self._buf[_PH_RCLOSED_OFF] = 1

    def _release_slot(self, index: int) -> None:
        with self._lock:
            if self._buf is not None:
                with contextlib.suppress(Exception):
                    self._buf[_PH_STATES_OFF + index] = 0
            self._outstanding -= 1
            if self._close_deferred and self._outstanding <= 0:
                self._close_now()

    def _close_now(self) -> None:
        self._close_deferred = False
        self._buf = None
        shm = self._shm
        try:
            shm.close()
        except BufferError:
            # Decoded views are still exported (dealloc ordering runs the
            # lease's __del__ before the view dies, or the caller kept a
            # raw buffer): the mmap must outlive them, and dies with the
            # last view. Disarm the handle — close() bailed before the
            # fd, and SharedMemory.__del__ would re-raise noisily at GC.
            shm._mmap = None  # noqa: SLF001
            if shm._fd >= 0:  # noqa: SLF001
                with contextlib.suppress(OSError):
                    os.close(shm._fd)  # noqa: SLF001
                shm._fd = -1  # noqa: SLF001
        except Exception:  # pragma: no cover - best-effort teardown
            pass

    def release(self, unlink: bool = False) -> None:
        """Unlink the name now (if asked); drop the mapping when the last
        outstanding lease is released. Idempotent."""
        with self._lock:
            if self._released:
                return
            self._released = True
            if unlink:
                _unlink_quiet(self._name)
            if self._outstanding > 0:
                self._close_deferred = True
            else:
                self._close_now()


# ---- one direction: control ring + lazy slot pool ----------------------------

class Chan:
    """One direction of a connection.

    Small messages gather straight into the control ring. Larger ones go
    through the direction's *slot pool* (see :class:`SlotPool`) — created
    lazily by the writer, reused for the connection's lifetime, regrown
    under a fresh versioned name when a bigger message arrives. A tiny
    ``_REF_MAGIC`` reference (segment name + slot index + length) enters
    the control ring; the reader attaches the named pool (cached) and
    decodes the slot **in place** — the slot frees when the decoded
    message's lease dies, so pipelined large messages use distinct slots
    concurrently. ``zero_copy=False`` selects the copy-out receive
    instead (one full copy per message, slot freed immediately): the A/B
    baseline arm in benchmarks/rpc_overhead.py. The per-direction send
    lock keeps slot fills and control records in lockstep order.
    """

    def __init__(self, ctrl: Ring, bulk_name: str, writer: bool,
                 zero_copy: bool = True):
        self._ctrl = ctrl
        self._bulk_name = bulk_name
        self._writer = writer
        self._zero_copy = zero_copy
        self._pool: Optional[SlotPool] = None
        self._pool_version = 0
        self._retired: list[SlotPool] = []
        self._pools_attached: dict[str, SlotPool] = {}
        self._lock = threading.Lock()
        # Telemetry counters (plain ints: GIL-atomic +=, read by stats()).
        self.bytes_out = 0
        self.bytes_in = 0
        self.serialize_us = 0
        self.pool_grows = 0

    # -- writer side ---------------------------------------------------------
    def _new_pool(self, slot_size: int) -> SlotPool:
        self.pool_grows += 1
        if self._pool is not None:
            # The replaced pool may still hold in-flight messages (refs
            # in the ring, leases on the consumer); park it and unlink
            # once every slot has been released.
            self._retired.append(self._pool)
        self._pool_version += 1
        self._pool = SlotPool.create(
            f"{self._bulk_name}v{self._pool_version}", slot_size=slot_size)
        return self._pool

    def _writer_pool(self, total: int) -> SlotPool:
        if self._pool is None or self._pool.slot_size < total:
            self._new_pool(int(total * SLOT_HEADROOM))
        self._reap_retired()
        return self._pool

    def _reap_retired(self) -> None:
        keep = []
        for pool in self._retired:
            if pool.all_free:
                pool.release(unlink=True)
            else:
                keep.append(pool)
        self._retired = keep

    def send(self, kind: int, req_id: int, obj: Any,
             timeout: Optional[float] = None, give_up=None) -> None:
        t0 = time.perf_counter()
        frames = ser.encode_frames(obj)
        total = ser.framed_size(frames)
        self.serialize_us += int((time.perf_counter() - t0) * 1e6)
        self.bytes_out += total
        with self._lock:
            if total <= SPILL_THRESHOLD:
                self._ctrl.write(kind, req_id, ser.framed_chunks(frames),
                                 timeout=timeout, give_up=give_up)
                return
            pool = self._writer_pool(total)
            try:
                grace = _POOL_GROW_GRACE_S if timeout is None \
                    else min(timeout, _POOL_GROW_GRACE_S)
                index = pool.acquire(timeout=grace, give_up=give_up)
            except TimeoutError:
                # The consumer leases every slot (e.g. more pipelined
                # results alive than SLOT_COUNT). Expand with a fresh
                # pool instead of deadlocking: the stalled pool drains as
                # results are dropped and is then reaped, so memory
                # tracks actual concurrent retention. The grace keeps
                # soft backpressure against runaway producers.
                pool = self._new_pool(pool.slot_size)
                index = pool.acquire(timeout=timeout, give_up=give_up)
            try:
                pool.write_frames_at(index, frames)
                name_b = pool.name.encode()
                ref = (_REF_MAGIC + _REF_NAME.pack(len(name_b)) + name_b
                       + _REF_TAIL.pack(index, total))
                self._ctrl.write(kind, req_id, [ref], timeout=timeout,
                                 give_up=give_up)
            except BaseException:
                # The reference never entered the ring: return the slot
                # so later sends don't wait on a message nobody consumes.
                pool.abandon(index)
                raise

    # -- reader side ---------------------------------------------------------
    def recv(self, timeout: Optional[float] = None, give_up=None
             ) -> Optional[tuple[int, int, Any]]:
        """Pop and decode one message. A payload that fails to decode
        (e.g. a class importable only on the peer) comes back as a
        :class:`DecodeFailure` so the request id is not lost — the caller
        can still correlate an error reply."""
        rec = self._ctrl.read(timeout=timeout, give_up=give_up)
        if rec is None:
            return None
        kind, req_id, body = rec
        try:
            obj = self._decode(body)
        except (RingClosed, KeyboardInterrupt, SystemExit):
            raise  # interrupts reach the driving caller, not a reply
        except BaseException as exc:  # noqa: BLE001
            obj = DecodeFailure(exc)
        return kind, req_id, obj

    def _decode(self, body) -> Any:
        # ``body`` is bytes or a memoryview; compare/parse through
        # memoryview slices — no intermediate ``bytes`` materialization.
        mv = memoryview(body)
        if mv.nbytes >= 2 and mv[:2] == _REF_MAGIC:
            (name_len,) = _REF_NAME.unpack_from(mv, 2)
            name = str(mv[4:4 + name_len], "ascii")
            index, total = _REF_TAIL.unpack_from(mv, 4 + name_len)
            self.bytes_in += total
            pool = self._pools_attached.get(name)
            if pool is None:
                pool = SlotPool.attach(name)
                # A new pool name means the writer regrew or expanded:
                # evict drained older attachments so superseded multi-MiB
                # mappings don't pin memory for the connection's
                # lifetime. all_free is a safe eviction test — any
                # in-flight message (published or not) holds its slot's
                # state byte at 1 until the consumer releases the lease;
                # an evicted-but-still-current pool just re-attaches by
                # name on its next reference.
                for old_name, old in list(self._pools_attached.items()):
                    if old.all_free:
                        old.release()
                        del self._pools_attached[old_name]
                self._pools_attached[name] = pool
            # The slot was filled and published before its control-ring
            # reference, so the message is already there.
            if not self._zero_copy:
                return ser.loads(pool.consume_copy(index, total))
            return ser.loads_owned(pool.view(index, total),
                                   pool.lease(index))
        self.bytes_in += mv.nbytes
        return ser.loads(body)

    # -- lifecycle -----------------------------------------------------------
    def close_write(self) -> None:
        with contextlib.suppress(Exception):
            self._ctrl.close_write()

    def close_read(self) -> None:
        with contextlib.suppress(Exception):
            self._ctrl.close_read()
        # Snapshot: the reply-driver thread may attach/evict concurrently.
        for pool in list(self._pools_attached.values()):
            pool.close_read()  # unblock a writer waiting on a leased slot

    @property
    def ctrl(self) -> Ring:
        return self._ctrl

    def release(self, unlink: bool = False) -> None:
        self._ctrl.release(unlink=unlink)
        if self._pool is not None:
            self._pool.release(unlink=True)  # writer owns the pool name
            self._pool = None
        for pool in self._retired:
            pool.release(unlink=True)
        self._retired = []
        for pool in list(self._pools_attached.values()):
            pool.release()  # mapping lives on under outstanding leases
        self._pools_attached.clear()


def _sweep_segments(prefix: str) -> None:
    """Best-effort unlink of leftover segments (crashed peer / unread
    spills). POSIX shm appears under /dev/shm on Linux."""
    for path in glob.glob(f"/dev/shm/{prefix}*"):
        with contextlib.suppress(Exception):
            _unlink_quiet(os.path.basename(path))


# ---- rendezvous --------------------------------------------------------------

def _root_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "courier-shm")


def rendezvous_dir(name: str) -> str:
    return os.path.join(_root_dir(), name)


def probe(name: str) -> str:
    """Listener state: ``"ready"`` | ``"stale"`` (dead pid / wrong host /
    unreadable meta) | ``"absent"``."""
    meta_path = os.path.join(rendezvous_dir(name), "listener.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return "absent"
    except Exception:
        return "stale"
    if meta.get("host") != socket.gethostname():
        return "stale"
    pid = meta.get("pid")
    if not isinstance(pid, int) or not _pid_alive(pid):
        return "stale"
    return "ready"


def cleanup(name: str) -> None:
    """Remove a service's rendezvous directory and leftover segments —
    used by launchers tearing down hard-killed nodes."""
    d = rendezvous_dir(name)
    with contextlib.suppress(Exception):
        for fn in os.listdir(d):
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(d, fn))
        os.rmdir(d)


# ---- server side -------------------------------------------------------------

class _ServerConn:
    """One accepted client: a reader thread draining the request channel
    and a reply channel shared by the handler pool."""

    def __init__(self, listener: "ShmListener", conn_id: str,
                 req: Ring, rep: Ring, client_pid: int,
                 zero_copy: bool = True):
        self._listener = listener
        self._conn_id = conn_id
        self._in = Chan(req, bulk_name=f"{conn_id}qb", writer=False,
                        zero_copy=zero_copy)
        self._out = Chan(rep, bulk_name=f"{conn_id}rb", writer=True)
        self._client_pid = client_pid
        self._thread = threading.Thread(
            target=self._serve, name=f"courier-shm-conn/{conn_id}",
            daemon=True)

    def start(self) -> None:
        self._out.ctrl.write(KIND_HELLO, 0, [b""])
        self._thread.start()

    def _client_gone(self) -> Optional[BaseException]:
        # Wakes reply writers blocked on a full ring whose client was
        # SIGKILLed (a dead client never sets its reader-closed flag).
        if not _pid_alive(self._client_pid):
            return RingClosed("client process died")
        return None

    def _reply(self, kind: int, req_id: int, obj: Any) -> None:
        try:
            self._out.send(kind, req_id, obj, give_up=self._client_gone)
        except RingClosed:
            pass  # client left; nothing to deliver the reply to
        except Exception:
            # Unpicklable result/exception: degrade per-status, exactly
            # like the gRPC path's encode_reply_error fallbacks.
            with contextlib.suppress(RingClosed):
                self._out.send(kind, req_id, _degrade(kind, obj),
                               give_up=self._client_gone)

    def _run_call(self, req_id: int, call: tuple) -> None:
        lst = self._listener
        try:
            # handler_init inside the try: its failure must become an
            # error reply, not a silently-dropped pool future that leaves
            # the client waiting forever.
            if lst.handler_init is not None:
                lst.handler_init()
            method, args, kwargs = call
            status = ser.make_ok_status(lst.invoke(method, args, kwargs))
        except BaseException as exc:  # noqa: BLE001 - ship any failure back
            status = ser.make_error_status(exc)
        self._reply(KIND_REPLY, req_id, status)

    def _run_batch(self, req_id: int, calls: list) -> None:
        lst = self._listener
        try:
            if lst.handler_init is not None:
                lst.handler_init()
        except BaseException as exc:  # noqa: BLE001 - whole-batch failure
            self._reply(KIND_REPLY, req_id, ser.make_error_status(exc))
            return
        statuses = []
        for method, args, kwargs in calls:
            # Per-call isolation, statuses in request order (same contract
            # as /courier/BatchCall).
            try:
                statuses.append(
                    ser.make_ok_status(lst.invoke(method, args, kwargs)))
            except BaseException as exc:  # noqa: BLE001
                statuses.append(ser.make_error_status(exc))
        self._reply(KIND_BATCH_REPLY, req_id, statuses)

    def _serve(self) -> None:
        try:
            while not self._listener.stopped:
                try:
                    # Decode happens here (slot consumption must follow
                    # control-ring order); only the invoke may run pooled.
                    rec = self._in.recv(timeout=0.2)
                except RingClosed:
                    return
                if rec is None:
                    if not _pid_alive(self._client_pid):
                        return  # client died without a CLOSE
                    continue
                kind, req_id, obj = rec
                rec = None
                if kind == KIND_CLOSE:
                    return
                if isinstance(obj, DecodeFailure):
                    self._reply(KIND_REPLY, req_id,
                                ser.make_error_status(obj.exc))
                    obj = None
                    continue
                if kind == KIND_CALL:
                    runner = self._run_call
                elif kind == KIND_BATCH:
                    runner = self._run_batch
                else:
                    obj = None
                    continue
                # A lone request runs inline: on small hosts a pool
                # hand-off costs a wake AND leaves this thread spinning
                # next to the worker. A client with pipelined backlog
                # keeps pool concurrency (its calls must not serialize
                # behind one long handler). Caveat: a handler that blocks
                # until a *later* request from the same client arrives
                # can stall its own connection — don't write services
                # like that (other clients' connections are unaffected).
                if self._in.ctrl.has_backlog():
                    try:
                        self._listener.pool.submit(runner, req_id, obj)
                    except RuntimeError:
                        return  # listener stopped the pool mid-accept
                else:
                    runner(req_id, obj)
                # Drop this thread's reference before blocking in recv
                # again: a zero-copy request pins its pool slot through
                # the decoded object's lease, which frees when the last
                # reference (here, or the handler's locals) dies.
                obj = None
        finally:
            self._out.close_write()
            self._in.close_read()
            self._in.release()
            self._out.release()
            _sweep_segments(f"{self._conn_id}")
            self._listener.forget(self)


def _degrade(kind: int, obj: Any) -> Any:
    """Build a picklable stand-in for a reply that failed to encode."""
    def one(status):
        try:
            ser.encode_frames(status)
            return status
        except Exception:
            if status[0] == "ok":
                return ("err", ser.RemoteError(
                    f"result of type {type(status[1]).__name__} is not "
                    "serializable"), "")
            return ("err", ser.RemoteError(repr(status[1])), status[2])
    if kind == KIND_BATCH_REPLY:
        return [one(s) for s in obj]
    return one(obj)


class ShmListener:
    """Accepts shm connections for one service name, alongside whatever
    other transports the server runs. ``invoke`` is the server's dispatch
    (method, args, kwargs) -> value; ``handler_init`` runs at the top of
    every request on the handling thread (same contract as CourierServer).
    """

    def __init__(self, name: str, invoke: Callable[[str, tuple, dict], Any],
                 handler_init: Optional[Callable[[], None]] = None,
                 max_workers: int = 16):
        if not supported():  # pragma: no cover - POSIX-only guard
            raise ShmConnectError("shm transport requires POSIX")
        self.name = name
        self.invoke = invoke
        self.handler_init = handler_init
        self.stopped = False
        self.pool = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="courier-shm-srv")
        self._dir = rendezvous_dir(name)
        self._conns: list[_ServerConn] = []
        self._conns_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None
        os.makedirs(self._dir, exist_ok=True)
        meta = {"host": socket.gethostname(), "pid": os.getpid(),
                "version": 1}
        tmp = os.path.join(self._dir, f".meta.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self._dir, "listener.json"))

    @property
    def endpoint(self) -> str:
        return f"shm://{self.name}"

    def start(self) -> None:
        if self._accept_thread is not None:
            return
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"courier-shm-accept/{self.name}",
            daemon=True)
        self._accept_thread.start()

    def _accept_one(self, path: str) -> None:
        try:
            with open(path) as f:
                req = json.load(f)
            os.unlink(path)
            conn = _ServerConn(self, req["conn"],
                               req=Ring.attach(req["req"]),
                               rep=Ring.attach(req["rep"]),
                               client_pid=int(req["pid"]),
                               zero_copy=bool(req.get("zc", True)))
        except Exception:  # malformed/raced connect file: drop it
            with contextlib.suppress(OSError):
                os.unlink(path)
            return
        with self._conns_lock:
            self._conns.append(conn)
        conn.start()

    def _accept_loop(self) -> None:
        while not self.stopped:
            try:
                pending = sorted(
                    fn for fn in os.listdir(self._dir)
                    if fn.endswith(".connect"))
            except FileNotFoundError:
                return  # rendezvous dir removed under us: stop accepting
            for fn in pending:
                self._accept_one(os.path.join(self._dir, fn))
            time.sleep(_POLL_ACCEPT_S)

    def forget(self, conn: _ServerConn) -> None:
        with self._conns_lock:
            if conn in self._conns:
                self._conns.remove(conn)

    def stop(self) -> None:
        if self.stopped:
            return
        self.stopped = True
        cleanup(self.name)  # unadvertise first: no new connects
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            # Wake blocked clients; the conn thread may be releasing the
            # ring concurrently, which is fine — the client also watches
            # our pid.
            conn._out.close_write()  # noqa: SLF001
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        self.pool.shutdown(wait=False)


# ---- client side -------------------------------------------------------------

class ClientConnection:
    """The client half of one shm connection: creates the rings, performs
    the rendezvous handshake, then sends records / receives replies."""

    def __init__(self, name: str, req: Ring, rep: Ring, conn_id: str,
                 server_pid: int, zero_copy: bool = True):
        self.name = name
        self._out = Chan(req, bulk_name=f"{conn_id}qb", writer=True)
        self._in = Chan(rep, bulk_name=f"{conn_id}rb", writer=False,
                        zero_copy=zero_copy)
        self._conn_id = conn_id
        self._server_pid = server_pid
        self._closed = False

    def io_stats(self) -> dict:
        """Wire-level counters for :meth:`ShmTransport.stats` — request
        bytes/serialize time from the outbound channel, reply bytes from
        the inbound one, pool regrows from both."""
        return {
            "bytes_out": self._out.bytes_out,
            "bytes_in": self._in.bytes_in,
            "serialize_us": self._out.serialize_us,
            "pool_grows": self._out.pool_grows + self._in.pool_grows,
        }

    @classmethod
    def connect(cls, name: str, wait: Optional[float] = None,
                zero_copy: bool = True) -> "ClientConnection":
        """``zero_copy=False`` selects the copy-out receive on *both*
        sides of this connection (the server mirrors the flag for its
        request channel) — the PR-2 baseline arm for paired A/B runs."""
        if not supported():
            raise ShmConnectError("shm transport requires POSIX")
        wait = CONNECT_WAIT_S if wait is None else wait
        deadline = time.monotonic() + wait
        # Wait for the listener to advertise (launch is asynchronous); a
        # stale advertisement (dead pid) fails immediately so callers can
        # fall back instead of hanging on a crashed server's leftovers.
        while True:
            state = probe(name)
            if state == "ready":
                break
            if state == "stale":
                raise ShmConnectError(
                    f"shm listener for {name!r} is stale (server crashed?)")
            if time.monotonic() >= deadline:
                raise ShmConnectError(
                    f"shm listener for {name!r} did not come up within "
                    f"{wait:.1f}s")
            time.sleep(0.005)
        d = rendezvous_dir(name)
        try:
            with open(os.path.join(d, "listener.json")) as f:
                server_pid = int(json.load(f)["pid"])
        except (OSError, ValueError, KeyError) as exc:
            # The listener can unadvertise between probe() and this read;
            # surface it as a connect failure so callers fall back.
            raise ShmConnectError(
                f"shm listener for {name!r} disappeared during connect: "
                f"{exc!r}") from exc
        conn_id = f"cur{os.getpid():x}{uuid.uuid4().hex[:8]}"
        req = Ring.create(f"{conn_id}q")
        rep = Ring.create(f"{conn_id}r")
        try:
            spec = {"conn": conn_id, "req": req.name, "rep": rep.name,
                    "pid": os.getpid(), "zc": bool(zero_copy)}
            tmp = os.path.join(d, f".{conn_id}.tmp")
            with open(tmp, "w") as f:
                json.dump(spec, f)
            os.replace(tmp, os.path.join(d, f"{conn_id}.connect"))
            # The HELLO record doubles as the accept ack.
            def _server_died():
                if not _pid_alive(server_pid):
                    return ShmConnectError(
                        f"shm listener for {name!r} died during handshake")
                return None
            rec = rep.read(timeout=ACCEPT_WAIT_S, give_up=_server_died)
            if rec is None or rec[0] != KIND_HELLO:
                raise ShmConnectError(
                    f"shm listener for {name!r} did not accept within "
                    f"{ACCEPT_WAIT_S:.1f}s")
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(d, f"{conn_id}.connect"))
            req.release(unlink=True)
            rep.release(unlink=True)
            raise
        return cls(name, req, rep, conn_id, server_pid,
                   zero_copy=zero_copy)

    # -- data path -----------------------------------------------------------
    def send(self, kind: int, req_id: int, obj: Any,
             timeout: Optional[float] = None) -> None:
        def _server_died():
            if not _pid_alive(self._server_pid):
                return RingClosed("server process died")
            return None
        self._out.send(kind, req_id, obj, timeout=timeout,
                       give_up=_server_died)

    def recv(self, timeout: Optional[float] = None
             ) -> Optional[tuple[int, int, Any]]:
        return self._in.recv(timeout=timeout)

    def peer_alive(self) -> bool:
        return _pid_alive(self._server_pid) and not self._in.ctrl.writer_closed

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with contextlib.suppress(Exception):
            self._out.ctrl.write(KIND_CLOSE, 0, [b""], timeout=0.2)
        self._out.close_write()
        self._in.close_read()

    def release(self) -> None:
        """Unlink the rings (the client created both control rings) plus
        any bulk/one-off segments left under this connection's prefix."""
        self._out.release(unlink=True)
        self._in.release(unlink=True)
        _sweep_segments(self._conn_id)
