"""Courier wire format: length-prefixed frames with out-of-band buffers.

Layout of a framed message (all integers little-endian)::

    MAGIC(2B) | nframes:u32 | len_0:u64 .. len_{n-1}:u64 | frame_0 | .. | frame_{n-1}

``frame_0`` is a pickle protocol-5 stream produced with a
``buffer_callback``; frames 1..n-1 are the raw out-of-band buffers
(numpy / CPU tensor payloads) it references. Array payloads are therefore
never copied into the pickle stream on encode, and on decode they are
reconstructed as zero-copy views over the received message — received
arrays are read-only; call ``np.copy`` before mutating in place.

CPU ``torch.Tensor``s are reduced through their numpy view at pickling
time and come back as numpy (bf16 as ``ml_dtypes.bfloat16``, as a bf16
``jax.Array`` does). CUDA tensors are refused with a
``TypeError``: RPC surfaces hand over numpy, and a device buffer never
travels implicitly (the caller copies to the host where it means to).
There is no pre-serialization deep-copy pass over the payload: container
types (including NamedTuple subclasses) are preserved exactly as pickle
sees them.

A message that does not start with MAGIC is treated as a bare cloudpickle
blob — the pre-frames legacy format, kept for wire compatibility and as
the benchmark baseline (see ``legacy_dumps``). ``loads`` transparently
decodes both.

Transports that own a writable destination buffer (the shm ring / slot
pools) skip the ``bytes`` join entirely via the scatter-gather API:
``encode_frames`` / ``framed_size`` / ``write_framed_into`` /
``framed_chunks`` / ``encode_call_into`` — each array payload is copied
exactly once, source array -> destination memory.

On the receive side, ``loads_owned`` decodes a framed message *in place*
over transport-owned memory (an shm pool slot) and threads an owner (the
slot's lease) under every decoded array, so the transport can reuse the
memory exactly when the consumer drops the message. ``owner_of`` /
``materialize`` let consumers inspect and detach such views.
"""

from __future__ import annotations

import io
import pickle
import struct
import traceback
from typing import Any, Sequence

import numpy as np
import torch

MAGIC = b"\xc5\x01"  # 'courier frames', version 1
_NFRAMES = struct.Struct("<I")
_FRAMELEN = struct.Struct("<Q")

# Legacy (pre-frames) pickle streams start with the pickle PROTO opcode
# (0x80), so MAGIC can never collide with them.
assert MAGIC[0] != 0x80


class RemoteError(RuntimeError):
    """An exception raised inside a remote service, re-raised client-side."""


def tensor_as_numpy(t: torch.Tensor) -> np.ndarray:
    """The numpy view of a CPU tensor; a CUDA tensor is refused.

    numpy has no bfloat16, so a bf16 tensor is viewed as its int16 bits
    reinterpreted as ``ml_dtypes.bfloat16`` — the same array a bf16
    ``jax.Array`` becomes under ``np.asarray``. ``ml_dtypes`` is imported
    only here, so a process that never ships bf16 never needs it."""
    if t.device.type != "cpu":
        raise TypeError(
            f"courier does not transport {t.device.type} tensors: pass "
            "numpy (or .cpu()) across an RPC boundary")
    t = t.detach().resolve_conj().resolve_neg()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _as_readonly(arr: np.ndarray) -> np.ndarray:
    view = arr.view()
    view.flags.writeable = False
    return view


_PICKLER_CLS: Any = None


def _pickler_cls():
    """cloudpickle plus tensor reduction, built on first use.

    cloudpickle is imported here, not at module import: the in-process
    transport never pickles, so the thread launcher runs without it.

    CPU tensors are reduced through their numpy view so, under protocol
    5, numpy emits the payload as an out-of-band ``PickleBuffer`` which the
    frame encoder ships uncopied.

    Array payloads are reduced through a *read-only view* on purpose: a
    readonly source makes the pickler emit the ``READONLY_BUFFER`` opcode,
    and on decode that opcode wraps the supplied buffer in
    ``memoryview(buf).toreadonly()`` — the wrap is what lets
    :func:`loads_owned` pin a transport lease under every decoded array
    (numpy collapses chains of *ndarray* bases, but stops at a
    memoryview), and what keeps received arrays read-only even when they
    alias writable shared memory.
    """
    global _PICKLER_CLS
    if _PICKLER_CLS is None:
        import cloudpickle

        class _CourierPickler(cloudpickle.CloudPickler):
            def reducer_override(self, obj):
                if isinstance(obj, torch.Tensor):
                    return _as_readonly(
                        tensor_as_numpy(obj)).__reduce_ex__(5)
                if type(obj) is np.ndarray and obj.flags.writeable:
                    # Plain ndarrays are the only types that emit
                    # out-of-band buffers in this codebase (subclasses
                    # reduce in-band).
                    return _as_readonly(obj).__reduce_ex__(5)
                return super().reducer_override(obj)

        _PICKLER_CLS = _CourierPickler
    return _PICKLER_CLS


# ---- framed encode / decode -------------------------------------------------

def dumps(obj: Any) -> bytes:
    """Serialize ``obj`` into a framed message (out-of-band array buffers)."""
    frames = encode_frames(obj)
    parts: list[Any] = [MAGIC, _NFRAMES.pack(len(frames))]
    parts.extend(_FRAMELEN.pack(f.nbytes) for f in frames)
    parts.extend(frames)
    return b"".join(parts)


def is_framed(data: bytes) -> bool:
    return len(data) >= 2 and bytes(data[:2]) == MAGIC


# ---- scatter-gather encode ---------------------------------------------------
#
# ``dumps`` joins the pickle stream and every out-of-band buffer into one
# intermediate ``bytes`` — fine for gRPC (which needs a single message
# object anyway), but a wasted copy for transports that own a writable
# destination buffer (the shm ring / spill segments). The functions below
# expose the frame list itself so such transports can copy each payload
# exactly once, source array -> destination memory.

def encode_frames(obj: Any) -> list:
    """Pickle ``obj`` and return its frames uncombined.

    Element 0 is the protocol-5 pickle stream; elements 1..n-1 are the raw
    out-of-band buffers (views over the *original* arrays — nothing is
    copied). Pass the list to :func:`write_framed_into` /
    :func:`framed_size` or decode it with :func:`decode_frames`.
    """
    buffers: list[pickle.PickleBuffer] = []
    stream = io.BytesIO()
    _pickler_cls()(stream, protocol=5,
                   buffer_callback=buffers.append).dump(obj)
    frames: list[Any] = [stream.getbuffer()]
    for buf in buffers:
        try:
            frames.append(buf.raw())
        except BufferError:  # non-contiguous exotic buffer: copy once
            frames.append(memoryview(bytes(buf)))
    return frames


def framed_size(frames: Sequence) -> int:
    """Total byte size of the framed message :func:`write_framed_into` emits."""
    return (len(MAGIC) + _NFRAMES.size + _FRAMELEN.size * len(frames)
            + sum(memoryview(f).nbytes for f in frames))


# numpy's copy path beats memoryview slicing ~2x for large transfers on
# the kernels we deploy on; below this size its setup overhead loses.
_NP_COPY_MIN = 4096


def copy_into(out, offset: int, v) -> None:
    """Copy buffer ``v`` into ``out`` at ``offset`` at full memcpy speed."""
    v = memoryview(v).cast("B")
    if v.nbytes > _NP_COPY_MIN:
        np.copyto(
            np.frombuffer(out, np.uint8, count=v.nbytes, offset=offset),
            np.frombuffer(v, np.uint8))
    else:
        memoryview(out)[offset:offset + v.nbytes] = v


def read_copy(buf, offset: int, n: int):
    """Copy ``n`` bytes out of ``buf`` into fresh memory (bytes-like)."""
    if n > _NP_COPY_MIN:
        return np.frombuffer(buf, np.uint8, count=n, offset=offset).copy().data
    return bytes(memoryview(buf)[offset:offset + n])


def write_framed_into(buf, frames: Sequence) -> int:
    """Write the standard framed message directly into writable ``buf``.

    This is the scatter-gather twin of :func:`dumps`: each frame payload is
    copied exactly once into ``buf`` (no intermediate join). Returns the
    number of bytes written; raises ``ValueError`` if ``buf`` is too small.
    """
    out = memoryview(buf)
    total = framed_size(frames)
    if out.nbytes < total:
        raise ValueError(
            f"framed message needs {total} bytes; buffer has {out.nbytes}")
    out[:len(MAGIC)] = MAGIC
    offset = len(MAGIC)
    _NFRAMES.pack_into(out, offset, len(frames))
    offset += _NFRAMES.size
    views = [memoryview(f) for f in frames]
    for v in views:
        _FRAMELEN.pack_into(out, offset, v.nbytes)
        offset += _FRAMELEN.size
    for v in views:
        copy_into(out, offset, v)
        offset += v.nbytes
    return offset


def framed_chunks(frames: Sequence) -> list:
    """The framed message as a scatter list ``[header, frame_0, ...]``.

    Copy each element into the destination in order and you get exactly the
    bytes :func:`write_framed_into` produces — this is what the shm ring
    uses to gather a message into reserved ring space without a join.
    """
    views = [memoryview(f).cast("B") for f in frames]
    head = bytearray(MAGIC)
    head += _NFRAMES.pack(len(views))
    for v in views:
        head += _FRAMELEN.pack(v.nbytes)
    return [head, *views]


def encode_call_into(buf, method: str, args: tuple, kwargs: dict) -> int:
    """Scatter-gather :func:`encode_call`: frame the call directly into
    ``buf`` (e.g. a ring-buffer reservation), skipping the intermediate
    ``bytes`` that :func:`encode_call` produces. Returns bytes written."""
    return write_framed_into(buf, encode_frames((method, args, kwargs)))


def decode_frames(frames: Sequence) -> Any:
    """Decode a frame list produced by :func:`encode_frames` (or parsed off
    a framed message). Buffers alias the passed frames — zero-copy."""
    return pickle.loads(frames[0], buffers=[memoryview(f).cast("B")
                                            for f in frames[1:]])


def _parse_frame_spans(mv) -> list[tuple[int, int]]:
    """Parse a framed message's header: per-frame ``(offset, length)``."""
    (nframes,) = _NFRAMES.unpack_from(mv, 2)
    offset = 2 + _NFRAMES.size
    lengths = []
    for _ in range(nframes):
        (n,) = _FRAMELEN.unpack_from(mv, offset)
        lengths.append(n)
        offset += _FRAMELEN.size
    spans = []
    for n in lengths:
        spans.append((offset, n))
        offset += n
    return spans


def loads(data: bytes) -> Any:
    """Deserialize a framed message; falls back to bare-pickle (legacy)."""
    if not is_framed(data):
        return pickle.loads(data)
    mv = memoryview(data)
    frames = [mv[off:off + n] for off, n in _parse_frame_spans(mv)]
    # Buffers alias the received message: zero-copy, read-only arrays.
    return pickle.loads(frames[0], buffers=frames[1:])


# ---- decode with owner (transport-leased memory) ----------------------------
#
# ``loads`` over a transport-owned buffer (an shm slot) would hand out
# arrays whose lifetime the transport cannot see — it would never know
# when the slot may be reused. ``loads_owned`` threads an *owner* object
# (an ``shm.SlotLease``) under every decoded array: each out-of-band
# buffer handed to the unpickler is an ``_OwnedBuffer`` carrying the
# owner, the encoder's READONLY_BUFFER opcode wraps it in a memoryview
# (``.obj`` pins the _OwnedBuffer — numpy's view-base collapsing walks
# ndarray bases but stops at a memoryview), and so the owner's refcount
# hits zero exactly when the last decoded array dies. CPython refcounting
# makes the release prompt; the owner's ``__del__``/``release()`` then
# frees the slot.

class _OwnedBuffer(np.ndarray):
    """A uint8 view over transport-owned memory that keeps its owner (a
    slot lease) alive for as long as any decoded array aliases it."""

    _owner: Any = None


def loads_owned(view, owner: Any) -> Any:
    """Decode a framed message in place over transport-owned memory.

    ``view`` must be a *writable* buffer over the framed message (writable
    so the READONLY_BUFFER wrap actually happens — see ``_OwnedBuffer``);
    decoded arrays alias it, are read-only, and keep ``owner`` alive until
    the last of them is garbage-collected.
    """
    mv = memoryview(view).cast("B")
    if mv.readonly:
        raise ValueError(
            "loads_owned requires a writable view (a readonly buffer is "
            "passed through by the unpickler unwrapped, losing the owner)")
    if not (mv.nbytes >= 2 and mv[:2] == MAGIC):
        # Not a framed message (never produced by our slot writers):
        # decode a private copy, nothing can alias the slot.
        return pickle.loads(bytes(mv))
    spans = _parse_frame_spans(mv)
    (off0, n0), buf_spans = spans[0], spans[1:]
    buffers = []
    for offset, n in buf_spans:
        frame = np.frombuffer(mv, np.uint8, count=n,
                              offset=offset).view(_OwnedBuffer)
        frame.flags.writeable = True
        frame._owner = owner
        buffers.append(frame)
    return pickle.loads(mv[off0:off0 + n0], buffers=buffers)


def owner_of(arr: Any) -> Any:
    """The transport owner (slot lease) ``arr`` pins, or None.

    Walks the base chain: decoded array -> numpy view(s) -> the readonly
    memoryview the unpickler made -> the ``_OwnedBuffer`` carrying the
    owner."""
    node = arr
    while node is not None:
        if isinstance(node, _OwnedBuffer):
            return node._owner
        if isinstance(node, np.ndarray):
            node = node.base
        elif isinstance(node, memoryview):
            node = node.obj
        else:
            return None
    return None


def materialize(obj: Any) -> Any:
    """Deep-copy every transport-owned array view inside ``obj``.

    A decoded message's arrays may alias a shared-memory slot; holding
    them long-term pins the slot (starving the sender's slot pool).
    ``materialize`` returns an equivalent structure whose arrays own their
    memory, releasing the underlying lease(s) once the original is
    dropped. Containers (list/tuple/dict, incl. NamedTuples) are rebuilt
    only along paths that contain owned arrays."""
    if isinstance(obj, np.ndarray):
        return obj.copy() if owner_of(obj) is not None else obj
    if isinstance(obj, (list, tuple)):
        conv = [materialize(v) for v in obj]
        if all(a is b for a, b in zip(conv, obj)):
            return obj
        if isinstance(obj, tuple):
            return type(obj)(*conv) if hasattr(obj, "_fields") \
                else tuple(conv)
        return conv
    if isinstance(obj, dict):
        conv = {k: materialize(v) for k, v in obj.items()}
        if all(conv[k] is obj[k] for k in obj):
            return obj
        return conv
    return obj


# ---- legacy (pre-frames) encode ---------------------------------------------
#
# Frozen copy of the original wire format: a recursive deep-copy pass that
# converts tensor leaves to numpy, then one in-band cloudpickle blob. Kept so
# mixed-version peers interoperate and so benchmarks/rpc_overhead.py can
# measure the old format against the new one over the same server.

def _legacy_to_transportable(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return tensor_as_numpy(obj)
    if isinstance(obj, (list, tuple)):
        conv = [_legacy_to_transportable(v) for v in obj]
        if isinstance(obj, tuple):
            # Preserve NamedTuple subclasses (the original code collapsed
            # them to plain tuples).
            return type(obj)(*conv) if hasattr(obj, "_fields") else tuple(conv)
        return conv
    if isinstance(obj, dict):
        return {k: _legacy_to_transportable(v) for k, v in obj.items()}
    return obj


def legacy_dumps(obj: Any) -> bytes:
    import cloudpickle
    return cloudpickle.dumps(_legacy_to_transportable(obj), protocol=5)


def _dumps(obj: Any, legacy: bool) -> bytes:
    return legacy_dumps(obj) if legacy else dumps(obj)


# ---- call / reply framing ---------------------------------------------------

def encode_call(method: str, args: tuple, kwargs: dict,
                legacy: bool = False) -> bytes:
    return _dumps((method, args, kwargs), legacy)


def decode_call(data: bytes) -> tuple[str, tuple, dict]:
    return loads(data)


def encode_reply_ok(value: Any, legacy: bool = False) -> bytes:
    return _dumps(("ok", value), legacy)


def _error_tuple(exc: BaseException) -> tuple:
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    return ("err", exc, tb)


def encode_reply_error(exc: BaseException, legacy: bool = False) -> bytes:
    status = _error_tuple(exc)
    try:
        return _dumps(status, legacy)
    except Exception:  # unpicklable exception object
        return _dumps(("err", RemoteError(repr(exc)), status[2]), legacy)


def _raise_remote(status: tuple) -> None:
    _, exc, tb = status
    raise RemoteError(f"remote call failed:\n{tb}") from exc


def decode_reply(data: bytes) -> Any:
    msg = loads(data)
    if msg[0] == "ok":
        return msg[1]
    _raise_remote(msg)


# ---- batch call / reply framing ---------------------------------------------
#
# A batch ships N calls in ONE framed message (one pickle stream, one set of
# shared out-of-band buffers) and returns N per-call statuses in one reply.
# Statuses preserve request order; a failing call never aborts its siblings.

def encode_batch_call(calls: Sequence[tuple[str, tuple, dict]],
                      legacy: bool = False) -> bytes:
    return _dumps(("batch", list(calls)), legacy)


def decode_batch_call(data: bytes) -> list[tuple[str, tuple, dict]]:
    tag, calls = loads(data)
    if tag != "batch":
        raise ValueError(f"not a batch call message: {tag!r}")
    return calls


def encode_batch_reply(statuses: Sequence[tuple], legacy: bool = False) -> bytes:
    statuses = list(statuses)
    try:
        # Fast path: one pickling pass over the whole batch.
        return _dumps(("batch_reply", statuses), legacy)
    except Exception:
        pass
    # Some status is unpicklable (an exotic exception, or an 'ok' value such
    # as a lock/handle). Isolate per status so siblings still come back.
    safe = []
    for status in statuses:
        try:
            _dumps(status, legacy)
            safe.append(status)
        except Exception:
            if status[0] == "ok":
                safe.append(("err", RemoteError(
                    f"result of type {type(status[1]).__name__} is not "
                    "serializable"), ""))
            else:
                safe.append(("err", RemoteError(repr(status[1])), status[2]))
    return _dumps(("batch_reply", safe), legacy)


def make_ok_status(value: Any) -> tuple:
    return ("ok", value)


def make_error_status(exc: BaseException) -> tuple:
    return _error_tuple(exc)


def decode_batch_reply(data: bytes) -> list[tuple]:
    msg = loads(data)
    if msg[0] == "err":  # whole-batch failure (e.g. undecodable request)
        _raise_remote(msg)
    tag, statuses = msg
    if tag != "batch_reply":
        raise ValueError(f"not a batch reply message: {tag!r}")
    return statuses


def status_to_result(status: tuple) -> Any:
    """Unwrap one batch status: return the value or raise RemoteError."""
    if status[0] == "ok":
        return status[1]
    _raise_remote(status)


def status_to_exception(status: tuple) -> RemoteError:
    """Build (without raising) the client-side error for an 'err' status."""
    _, exc, tb = status
    err = RemoteError(f"remote call failed:\n{tb}")
    err.__cause__ = exc
    return err
