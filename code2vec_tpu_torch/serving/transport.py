"""The serving mesh's worker wire: one framed protocol, two carriers (the
port of ``code2vec_tpu/serving/transport.py``; it imports no JAX, but
the port keeps its own copy).

- **One frame format, checksummed.** Every message (dispatch, result,
  control, heartbeat) crosses as a length-prefixed frame::

      MAGIC(2) | length(4, big-endian) | crc32(4, big-endian) | payload

  where ``payload`` is the pickled message tuple. ``decode_frame``
  checks magic, length and CRC and raises a typed ``WireError`` on any
  mismatch, so a partial or corrupted frame fails the replica typed
  instead of poisoning the stream (the mesh treats it as a worker death:
  redispatch and supervised restart). The bytes are the reference's: a
  frame of plain values encodes the same in both packages.
- **Pipe and TCP carriers, identical protocol.** ``PipeTransport`` wraps
  the spawn pipe (``send_bytes``/``recv_bytes`` keep message boundaries;
  the frame adds integrity). ``SocketTransport`` carries the same frames
  over TCP: the mesh opens a ``SocketListener``, each worker dials in
  and introduces itself with a ``hello`` frame (rid, wire protocol
  version, pid), then reports ``('ready', {params_step, capabilities})``
  or ``('failed', reason)`` after its cold start, the two-phase startup
  of the pipe mode.
- **Typed heartbeats.** ``Heartbeat`` is the reference's schema-versioned
  payload; a mismatched one fails the replica typed. Besides liveness it
  carries the fleet observability backhaul: finished span records that
  missed their result frame, and, with ``MESH_TELEMETRY_BACKHAUL`` on,
  the worker's registry snapshot and memory-ledger rollup.
  ``ClockOffset`` estimates each worker incarnation's monotonic-clock
  offset from the ready frame and the beats; the parent shifts the
  worker's span stamps by it when it stitches them.

A dial-in whose rid the mesh did not spawn is a worker started outside
the mesh (``python -m code2vec_tpu_torch.serving.mesh_worker``, run by an
orchestrator): the listener queues it for adoption.

Stdlib only, above the serving errors; nothing here touches the card.
"""
from __future__ import annotations

import dataclasses
import pickle
import select
import socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from code2vec_tpu_torch.serving.errors import WireError

#: wire protocol version carried in the socket ``hello`` frame (the
#: reference's): a parent refuses a worker speaking a different framing
#: or message set instead of misparsing it. In v2 a dispatch frame
#: carries one trace context per member (``{'trace_id', 'sampled',
#: 'scenario'}``, or None for an untraced member) as its fifth element,
#: and a result frame the members' span bundles as its fourth.
WIRE_PROTO = 2

#: schema version of the ``Heartbeat`` payload, distinct from WIRE_PROTO:
#: a worker built against another payload shape fails typed at the
#: receiver
HEARTBEAT_SCHEMA = 1


@dataclasses.dataclass
class Heartbeat:
    """The worker -> mesh liveness payload, one per
    ``MESH_HEARTBEAT_SECS`` (the reference's schema, whole):

    - ``inflight``: the worker's self-reported in-flight dispatch count
      (``worker_reported_inflight`` in ``mesh.stats()``);
    - ``t_mono``: the worker's ``time.perf_counter()`` at send time, one
      ``ClockOffset`` sample per beat;
    - ``spans``: finished worker-side span bundles (``{'seq', 'member',
      'trace', 'status', 'spans'}``) older than half a beat, not shipped
      on a result frame (they finished late, or a crash is about to
      orphan them);
    - ``telemetry``: the worker's registry snapshot for the fleet merge,
      None with ``MESH_TELEMETRY_BACKHAUL`` at 0;
    - ``ledger``: a rollup of the worker's memory ledger
      (``{'attributed_bytes', 'budget_bytes', 'buckets'}``), None with
      the backhaul at 0.
    """
    schema: int = HEARTBEAT_SCHEMA
    inflight: int = 0
    t_mono: float = 0.0
    spans: List[dict] = dataclasses.field(default_factory=list)
    telemetry: Optional[Dict[str, object]] = None
    ledger: Optional[Dict[str, object]] = None


def check_heartbeat(payload) -> 'Heartbeat':
    """Validate one received heartbeat payload; raises ``WireError`` on
    a non-``Heartbeat`` object or a schema mismatch, the typed shape of
    version skew between a worker and its mesh."""
    if not isinstance(payload, Heartbeat):
        raise WireError('heartbeat payload is %s, not Heartbeat '
                        '(worker speaks a different payload schema)'
                        % type(payload).__name__)
    if payload.schema != HEARTBEAT_SCHEMA:
        raise WireError('heartbeat schema %r != expected %d (worker '
                        'built against a different payload version)'
                        % (payload.schema, HEARTBEAT_SCHEMA))
    return payload


class ClockOffset:
    """One worker incarnation's monotonic-clock offset estimate, so
    remote stamps land in the parent's timeline in order.

    Each one-way sample (a frame stamped ``remote_t`` at send, received
    at ``local_t``) bounds the true offset from above: ``local_t =
    remote_t + offset_true + wire_delay`` with ``wire_delay >= 0``. The
    estimate keeps the minimum over samples (the ready handshake and
    every heartbeat), converging to ``offset_true + min_delay``. Apply as
    ``t_parent = t_remote + offset``.
    """

    # samples arrive on the receiver thread while readers read the
    # estimate: both under _lock
    def __init__(self):
        self._lock = threading.Lock()
        self._offset: Optional[float] = None
        self._samples = 0

    def observe(self, remote_t: Optional[float],
                local_t: Optional[float] = None) -> None:
        """Feed one (remote send stamp, local receive stamp) sample."""
        if remote_t is None:
            return
        if local_t is None:
            local_t = time.perf_counter()
        sample = local_t - float(remote_t)
        with self._lock:
            self._samples += 1
            if self._offset is None or sample < self._offset:
                self._offset = sample

    @property
    def offset(self) -> float:
        """Current estimate in seconds (0.0 before any sample)."""
        with self._lock:
            return self._offset if self._offset is not None else 0.0

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

_MAGIC = b'c2'
# header layout: MAGIC (2 bytes) + length (4) + crc32 (4) = 10 bytes
_HEADER_LEN = 10
_LEN_CRC = struct.Struct('>II')

#: sanity bound on one frame: a corrupted length field must fail fast,
#: not allocate gigabytes.  Generous vs real traffic (a 1024-row packed
#: dispatch is ~MBs).
MAX_FRAME_BYTES = 1 << 30


def encode_frame(message) -> bytes:
    """Message tuple -> one framed byte string (pickle payload with a
    length + CRC32 header)."""
    payload = pickle.dumps(message)
    return (_MAGIC + _LEN_CRC.pack(len(payload),
                                   zlib.crc32(payload) & 0xFFFFFFFF)
            + payload)


def decode_frame(data: bytes):
    """One complete framed byte string -> message.  Raises ``WireError``
    on bad magic, truncation, trailing bytes, or CRC mismatch — the
    typed shape of a worker dying mid-write."""
    if len(data) < _HEADER_LEN:
        raise WireError('truncated frame: %d bytes < %d-byte header'
                        % (len(data), _HEADER_LEN))
    if data[:2] != _MAGIC:
        raise WireError('bad frame magic %r (stream corrupt or peer '
                        'speaks a different protocol)' % data[:2])
    length, crc = _LEN_CRC.unpack_from(data, 2)
    if length > MAX_FRAME_BYTES:
        raise WireError('frame length %d exceeds the %d-byte bound '
                        '(corrupted header)' % (length, MAX_FRAME_BYTES))
    payload = data[_HEADER_LEN:]
    if len(payload) != length:
        raise WireError('truncated frame: %d payload bytes, header '
                        'promised %d' % (len(payload), length))
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise WireError('frame CRC mismatch (worker died mid-write or '
                        'stream corrupt)')
    try:
        return pickle.loads(payload)
    except Exception as exc:
        raise WireError('frame payload failed to unpickle: %r' % exc)


class PipeTransport:
    """Framed messages over a ``multiprocessing`` connection.  The
    pipe keeps message boundaries; the frame adds the integrity check
    that turns a mid-write death into a typed ``WireError`` instead of
    a garbage object."""

    def __init__(self, conn):
        self._conn = conn

    def send(self, message) -> None:
        self._conn.send_bytes(encode_frame(message))

    def recv(self):
        """Blocking receive of one message.  Raises ``EOFError`` /
        ``OSError`` on a closed pipe, ``WireError`` on a bad frame."""
        return decode_frame(self._conn.recv_bytes())

    def poll(self, timeout: Optional[float] = 0.0) -> bool:
        return self._conn.poll(timeout)

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass


class SocketTransport:
    """Framed messages over a connected TCP socket, the carrier across
    hosts. ``recv`` reassembles exactly one frame from the byte
    stream (header first, then the promised payload); a short read
    inside a frame is a typed ``WireError``, a clean close at a frame
    boundary is ``EOFError`` (a worker death between messages)."""

    def __init__(self, sock: socket.socket):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not TCP (a unix socketpair in tests): no Nagle
        sock.settimeout(None)
        self._sock = sock

    def send(self, message) -> None:
        self._sock.sendall(encode_frame(message))

    def _read_exact(self, n: int, mid_frame: bool) -> bytes:
        chunks = []
        remaining = n
        while remaining:
            chunk = self._sock.recv(min(remaining, 1 << 20))
            if not chunk:
                if chunks or mid_frame:
                    raise WireError(
                        'socket closed mid-frame (%d of %d bytes read)'
                        % (n - remaining, n))
                raise EOFError('socket closed')
            chunks.append(chunk)
            remaining -= len(chunk)
        return b''.join(chunks)

    def recv(self):
        header = self._read_exact(_HEADER_LEN, mid_frame=False)
        if header[:2] != _MAGIC:
            raise WireError('bad frame magic %r' % header[:2])
        length, _crc = _LEN_CRC.unpack_from(header, 2)
        if length > MAX_FRAME_BYTES:
            raise WireError('frame length %d exceeds the %d-byte bound'
                            % (length, MAX_FRAME_BYTES))
        return decode_frame(header + self._read_exact(length,
                                                      mid_frame=True))

    def poll(self, timeout: Optional[float] = 0.0) -> bool:
        try:
            ready, _w, _x = select.select([self._sock], [], [], timeout)
        except (OSError, ValueError):
            return True  # closed socket: recv will raise the real error
        return bool(ready)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class SocketListener:
    """The mesh's accept side of socket mode: workers dial in, send a
    ``hello`` frame, and are claimed by rid, so N workers cold-start
    concurrently and connect in any order, and a worker needs only the
    (host, port) pair.

    Three kinds of dial-in. A rid the mesh ``expect()``ed (it spawned
    that worker) parks in the claim table for ``claim()``; a late hello
    from a dead incarnation of such a rid parks there too, and the claim
    pinned to the live pid drops it. Any other rid is a worker started
    outside the mesh and queues for adoption: ``wait_adoptable()`` hands
    it to the mesh's adoption loop. A hello speaking another wire
    protocol is refused typed: the worker receives an
    ``('adopt_rejected', reason)`` frame before the close."""

    # the accept thread fills _by_rid and _adoptable while wait_ready
    # callers claim, the adoption loop pops and close() tears them down:
    # the fields below under _lock (_cond wraps it)
    def __init__(self, host: str = '127.0.0.1'):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(16)
        self._sock.settimeout(0.25)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._by_rid: Dict[str, Tuple[SocketTransport, dict]] = {}
        self._expected: set = set()
        self._adoptable: List[Tuple[str, SocketTransport, dict]] = []
        self._rejected = 0
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name='mesh-listen')
        self._thread.start()

    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us
            try:
                conn.settimeout(30.0)
                transport = SocketTransport(conn)
                hello = transport.recv()
                conn.settimeout(None)
                if hello[0] != 'hello':
                    raise WireError('bad worker hello %r' % (hello[:1],))
                if hello[2] != WIRE_PROTO:
                    # the typed answer before the close: the dial-in
                    # learns why it was refused
                    with self._lock:
                        self._rejected += 1
                    try:
                        transport.send(('adopt_rejected',
                                        'wire proto %r != listener proto %d'
                                        % (hello[2], WIRE_PROTO)))
                    except (OSError, WireError):
                        pass
                    raise WireError(
                        'bad worker hello %r (wire proto %d expected)'
                        % (hello[:3], WIRE_PROTO))
            except (WireError, EOFError, OSError, socket.timeout,
                    IndexError, TypeError):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            with self._cond:
                if self._closed:
                    transport.close()
                    return
                # t_hello: when the dial-in introduced itself (an
                # adoption's clock starts here)
                rid, info = hello[1], {'pid': hello[3],
                                       't_hello': time.perf_counter()}
                if rid in self._expected:
                    self._by_rid[rid] = (transport, info)
                else:
                    # nobody here spawned this worker: it asks to be
                    # adopted
                    self._adoptable.append((rid, transport, info))
                self._cond.notify_all()

    def expect(self, rid: str) -> None:
        """Register a rid this mesh is about to spawn, so its dial-in
        lands in the claim table and not in the adoption queue. Must run
        before the worker process starts (the dial can beat any later
        bookkeeping)."""
        with self._cond:
            self._expected.add(rid)

    def wait_adoptable(self, timeout: float,
                       cancel: Optional[threading.Event] = None
                       ) -> Optional[Tuple[str, SocketTransport, dict]]:
        """Block up to ``timeout`` for one dial-in of a worker started
        outside the mesh; ``(rid, transport, info)``, or None on a
        timeout, a cancel or a closed listener."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while True:
                if self._adoptable:
                    return self._adoptable.pop(0)
                if self._closed:
                    return None
                if cancel is not None and cancel.is_set():
                    return None
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
                self._cond.wait(min(remaining, 0.25))

    @property
    def rejected_total(self) -> int:
        """Dial-ins refused at the hello (wrong wire protocol)."""
        with self._lock:
            return self._rejected

    def claim(self, rid: str, timeout: float,
              cancel: Optional[threading.Event] = None,
              pid: Optional[int] = None
              ) -> Tuple[SocketTransport, dict]:
        """Block until the worker named ``rid`` has dialed in (its hello
        validated), then hand its transport over. ``cancel`` aborts the
        wait early (the mesh closing during a supervised restart).

        ``pid`` pins the claim to one worker incarnation: a reaped
        predecessor's late hello (same rid, dead process) is dropped
        instead of handed to the restart, which would fail the attempt
        and spend a restart while the new worker sits unclaimed."""
        deadline = time.perf_counter() + timeout
        while True:
            stale = None
            with self._cond:
                entry = self._by_rid.get(rid)
                if entry is not None and pid is not None and \
                        entry[1].get('pid') != pid:
                    stale = self._by_rid.pop(rid)
                    entry = None
                if entry is not None:
                    return self._by_rid.pop(rid)
                if self._closed:
                    raise EOFError('mesh socket listener closed while '
                                   'waiting for replica %s' % rid)
                if cancel is not None and cancel.is_set():
                    raise RuntimeError('wait for replica %s cancelled '
                                       '(mesh closing)' % rid)
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise TimeoutError(
                        'replica %s worker did not dial in within %.0fs'
                        % (rid, timeout))
                self._cond.wait(min(remaining, 0.25))
            if stale is not None:
                stale[0].close()

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            unclaimed = list(self._by_rid.values())
            self._by_rid.clear()
            unclaimed.extend((transport, info)
                             for _rid, transport, info in self._adoptable)
            self._adoptable.clear()
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=10.0)
        for transport, _info in unclaimed:
            transport.close()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed


def dial(address: Tuple[str, int], rid: str, pid: int,
         timeout: float = 30.0, attempts: int = 3) -> SocketTransport:
    """Worker side of socket mode: connect to the mesh listener and
    introduce this replica (``hello`` carries the rid, the wire protocol
    and the pid; ``ready``/``failed`` follow after the cold start)."""
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            sock = socket.create_connection(tuple(address),
                                            timeout=timeout)
            transport = SocketTransport(sock)
            transport.send(('hello', rid, WIRE_PROTO, pid))
            return transport
        except OSError as exc:
            last = exc
            time.sleep(0.2 * (2 ** attempt))
    raise RuntimeError('replica %s could not dial the mesh listener at '
                       '%s: %r' % (rid, address, last))
