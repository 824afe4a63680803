"""The port's mesh wire (code2vec_tpu_torch/serving/transport.py) against
the reference's (code2vec_tpu/serving/transport.py), on the CPU, case by
case as tests/test_mesh_transport.py:

- framing: the same tuple of plain values encodes to the same bytes in
  both packages, and each package decodes the other's frames; truncated,
  corrupt and absurd-length frames fail typed (``WireError``) with the
  reference's messages;
- the pipe and TCP carriers: round trips, garbage and partial frames
  typed, a clean close an EOF;
- the socket listener: claims by rid, validates the hello (a wrong wire
  protocol is refused with a typed frame), queues a well-formed rid it
  did not expect for adoption (``wait_adoptable``) as the reference's
  does, keeps a dead incarnation's late hello of a spawned rid out of
  that queue, a claim can be cancelled, and close() closes what is
  queued and refuses later dials;
- the ``Heartbeat`` schema and its check, against the reference's.
"""
import dataclasses
import multiprocessing
import socket
import struct
import threading
import time

import pytest

from code2vec_tpu.serving import errors as ref_errors
from code2vec_tpu.serving import transport as ref_transport
from code2vec_tpu_torch.serving import transport as transport_lib
from code2vec_tpu_torch.serving.errors import WireError

BOTH = [(transport_lib, WireError), (ref_transport, ref_errors.WireError)]
PLAIN_MESSAGES = [
    ('dispatch', 7, 'topk', [b'payload', {'k': 1}]),
    ('result', 3, [['get', 'set'], [0.5, 0.25]], None),
    ('heartbeat', -1, {'inflight': 2}),
    ('ready', {'params_step': 5, 't_mono': 12.5,
               'capabilities': {'tiers': ['topk'], 'wire': 'packed',
                                'proto': 2}}),
    ('failed', "RuntimeError('no CUDA device')"),
]


# ------------------------------------------------------------- framing
@pytest.mark.parametrize('message', PLAIN_MESSAGES)
def test_frames_equal_the_reference_both_ways(message):
    frame = transport_lib.encode_frame(message)
    assert frame == ref_transport.encode_frame(message)
    assert transport_lib.decode_frame(frame) == message
    assert ref_transport.decode_frame(frame) == message
    assert transport_lib.decode_frame(
        ref_transport.encode_frame(message)) == message
    assert (transport_lib.WIRE_PROTO, transport_lib.MAX_FRAME_BYTES,
            transport_lib._HEADER_LEN) == (
        ref_transport.WIRE_PROTO, ref_transport.MAX_FRAME_BYTES,
        ref_transport._HEADER_LEN)


def _typed_message(lib, error, data):
    with pytest.raises(error) as exc:
        lib.decode_frame(data)
    return str(exc.value)


def test_truncated_frame_fails_typed():
    frame = transport_lib.encode_frame(('result', 3, ['x'] * 100))
    # a death mid-write can cut anywhere: the header, or the payload
    for cut in (1, 5, transport_lib._HEADER_LEN + 3, len(frame) - 1):
        got, want = (_typed_message(lib, error, frame[:cut])
                     for lib, error in BOTH)
        assert 'truncated' in got and got == want


def test_corrupted_frame_fails_typed():
    frame = bytearray(transport_lib.encode_frame(('result', 3, 'data')))
    frame[-1] ^= 0xFF   # a bit flip in the payload: the CRC catches it
    got, want = (_typed_message(lib, error, bytes(frame))
                 for lib, error in BOTH)
    assert 'CRC' in got and got == want
    bad_magic = b'XX' + bytes(frame)[2:]
    got, want = (_typed_message(lib, error, bad_magic)
                 for lib, error in BOTH)
    assert 'magic' in got and got == want


def test_absurd_length_header_fails_fast():
    # a length just over the bound, without allocating it
    bad = b'c2' + struct.pack('>II', transport_lib.MAX_FRAME_BYTES + 1, 0)
    got, want = (_typed_message(lib, error, bad + b'x')
                 for lib, error in BOTH)
    assert 'bound' in got and got == want


def test_unpicklable_payload_fails_typed():
    import zlib
    payload = b'not a pickle'
    frame = b'c2' + struct.pack('>II', len(payload),
                                zlib.crc32(payload) & 0xFFFFFFFF) + payload
    got, want = (_typed_message(lib, error, frame) for lib, error in BOTH)
    assert 'unpickle' in got and got == want


# ---------------------------------------------------------------- pipe
def test_pipe_transport_roundtrip_and_poison():
    parent, child = multiprocessing.Pipe()
    a = transport_lib.PipeTransport(parent)
    b = transport_lib.PipeTransport(child)
    a.send(('heartbeat', -1, {'inflight': 0}))
    assert b.poll(1.0)
    assert b.recv() == ('heartbeat', -1, {'inflight': 0})
    # garbage on the pipe: the receiver fails typed, it does not unpickle
    # a half-written object
    child.send_bytes(b'not a frame at all')
    with pytest.raises(WireError):
        a.recv()
    # a partial frame (the sender died mid-write of a large message)
    frame = transport_lib.encode_frame(('result', 0, list(range(1000))))
    child.send_bytes(frame[:len(frame) // 2])
    with pytest.raises(WireError, match='truncated'):
        a.recv()
    # the reference's transport on the far end speaks the same wire
    ref_transport.PipeTransport(child).send(('stats', 4))
    assert a.recv() == ('stats', 4)
    child.close()
    with pytest.raises((EOFError, OSError)):
        a.recv()
    a.close()


# -------------------------------------------------------------- socket
def test_socket_transport_roundtrip_partial_and_eof():
    left, right = socket.socketpair()
    a = transport_lib.SocketTransport(left)
    b = transport_lib.SocketTransport(right)
    big = ('dispatch', 1, 'topk', ['x' * 4096] * 16)
    a.send(big)
    a.send(('stats', 2))
    assert b.recv() == big   # reassembled across stream reads
    assert b.recv() == ('stats', 2)
    # a partial frame, then the close: the worker died mid-write
    frame = transport_lib.encode_frame(('result', 9, 'tail'))
    left.sendall(frame[:len(frame) - 3])
    left.close()
    with pytest.raises(WireError, match='mid-frame'):
        b.recv()
    # a clean close at a frame boundary is a plain EOF (a worker exit)
    left2, right2 = socket.socketpair()
    c = transport_lib.SocketTransport(left2)
    d = transport_lib.SocketTransport(right2)
    c.close()
    with pytest.raises(EOFError):
        d.recv()
    b.close()
    d.close()


def test_socket_listener_claims_by_rid_and_validates_hello():
    listener = transport_lib.SocketListener('127.0.0.1')
    try:
        # a spawned worker's rid is expected before it dials
        for rid in ('r0', 'r1', 'rX'):
            listener.expect(rid)
        # dial out of order: r1 first, then r0; claims are by rid. r1
        # dials with the reference's dial: one wire
        t1 = ref_transport.dial(listener.address, 'r1', pid=111)
        t0 = transport_lib.dial(listener.address, 'r0', pid=100)
        got0, hello0 = listener.claim('r0', timeout=10.0)
        got1, hello1 = listener.claim('r1', timeout=10.0)
        assert hello0['pid'] == 100 and hello1['pid'] == 111
        t0.send(('ready', {'params_step': 5}))
        assert got0.recv() == ('ready', {'params_step': 5})
        got1.send(('close', 0))
        assert t1.recv() == ('close', 0)
        # a peer speaking another wire protocol is refused typed at the
        # hello and never claimable, though its rid was expected
        bad = socket.create_connection(listener.address, timeout=5.0)
        bad_transport = transport_lib.SocketTransport(bad)
        bad_transport.send(
            ('hello', 'rX', transport_lib.WIRE_PROTO + 1, 1))
        kind, why = bad_transport.recv()[:2]
        assert kind == 'adopt_rejected' and 'proto' in why
        with pytest.raises(TimeoutError):
            listener.claim('rX', timeout=0.8)
        assert listener.rejected_total == 1
        # a well-formed rid this mesh did not spawn is queued for
        # adoption, never claimable by rid; the wrong proto was not
        assert listener.wait_adoptable(0.2) is None
        stranger = transport_lib.dial(listener.address, 'ext0', pid=7)
        rid, adoptable, info = listener.wait_adoptable(10.0)
        assert rid == 'ext0' and info['pid'] == 7
        with pytest.raises(TimeoutError):
            listener.claim('ext0', timeout=0.3)
        # its wire is the worker's: a frame crosses both ways
        stranger.send(('ready', {'params_step': 0}))
        assert adoptable.recv() == ('ready', {'params_step': 0})
        adoptable.send(('adopt_rejected', 'drill'))
        assert stranger.recv() == ('adopt_rejected', 'drill')
        assert listener.rejected_total == 1
        for transport in (t0, t1, got0, got1, stranger, adoptable):
            transport.close()
        bad.close()
    finally:
        listener.close()
    assert listener.closed
    # close() stopped the accept thread; a late dial is refused
    with pytest.raises(RuntimeError):
        transport_lib.dial(listener.address, 'r9', pid=9, timeout=0.5,
                           attempts=1)


def test_listener_claim_drops_a_stale_incarnation():
    """A claim pinned to a pid drops a reaped predecessor's hello (same
    rid, another pid) and waits for its own."""
    listener = transport_lib.SocketListener('127.0.0.1')
    try:
        listener.expect('r0')
        stale = transport_lib.dial(listener.address, 'r0', pid=1)
        out = {}

        def claim():
            out['got'] = listener.claim('r0', timeout=10.0, pid=2)

        thread = threading.Thread(target=claim)
        thread.start()
        with pytest.raises(EOFError):
            stale.recv()   # the stale socket was closed by the claim
        fresh = transport_lib.dial(listener.address, 'r0', pid=2)
        thread.join(10.0)
        got, hello = out['got']
        assert hello['pid'] == 2
        fresh.send(('ready', {}))
        assert got.recv() == ('ready', {})
        for transport in (stale, fresh, got):
            transport.close()
    finally:
        listener.close()


def test_listener_keeps_expected_stale_and_adoptable_apart():
    """Three kinds of dial-in under the one lock, as the reference's
    listener keeps them: a dead incarnation's late hello of a spawned rid
    stays in the claim table (the pinned claim drops it) and is never
    queued as a stranger; an unknown rid queues in arrival order; close()
    closes what was never claimed or adopted, and a waiter returns None."""
    listener = transport_lib.SocketListener('127.0.0.1')
    dials = []
    try:
        listener.expect('r0')
        stale = transport_lib.dial(listener.address, 'r0', pid=1)
        dials.append(stale)
        for i in range(2):
            dials.append(transport_lib.dial(listener.address, 'ext%d' % i,
                                            pid=10 + i))
        first = listener.wait_adoptable(10.0)
        second = listener.wait_adoptable(10.0)
        assert [first[0], second[0]] == ['ext0', 'ext1']
        dials += [first[1], second[1]]
        assert listener.wait_adoptable(0.3) is None   # r0 is not a stranger
        fresh = transport_lib.dial(listener.address, 'r0', pid=2)
        dials.append(fresh)
        got, hello = listener.claim('r0', timeout=10.0, pid=2)
        dials.append(got)
        assert hello['pid'] == 2
        with pytest.raises(EOFError):
            stale.recv()   # dropped by the pinned claim
        # one more stranger left queued when the listener closes
        late = transport_lib.dial(listener.address, 'ext2', pid=12)
        dials.append(late)
        deadline = time.perf_counter() + 10.0
        while not listener._adoptable:
            assert time.perf_counter() < deadline, 'ext2 never queued'
            time.sleep(0.01)
    finally:
        listener.close()
    with pytest.raises(EOFError):
        late.recv()
    assert listener.wait_adoptable(1.0) is None
    for transport in dials:
        transport.close()


def test_listener_claim_cancellable():
    listener = transport_lib.SocketListener('127.0.0.1')
    cancel = threading.Event()
    result = {}

    def wait():
        try:
            listener.claim('r0', timeout=30.0, cancel=cancel)
        except BaseException as exc:
            result['exc'] = exc

    thread = threading.Thread(target=wait)
    thread.start()
    cancel.set()
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    assert 'cancelled' in str(result['exc'])
    listener.close()


# ----------------------------------------------------------- heartbeat
def test_heartbeat_schema_equals_the_reference():
    def schema(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else f.default_factory()) for f in dataclasses.fields(cls)]

    assert schema(transport_lib.Heartbeat) == schema(ref_transport.Heartbeat)
    assert transport_lib.HEARTBEAT_SCHEMA == ref_transport.HEARTBEAT_SCHEMA


@pytest.mark.parametrize('payload', [
    'beat', {'inflight': 0}, None, ('heartbeat',),
    'schema+1', 'schema-0'])
def test_heartbeat_check_agrees_with_the_reference(payload):
    def made(lib):
        if payload == 'beat':
            return lib.Heartbeat(inflight=3, t_mono=1.5)
        if payload == 'schema+1':
            return lib.Heartbeat(schema=lib.HEARTBEAT_SCHEMA + 1)
        if payload == 'schema-0':
            return lib.Heartbeat(schema=0)
        return payload

    outcomes = []
    for lib, error in BOTH:
        try:
            beat = lib.check_heartbeat(made(lib))
            outcomes.append(('ok', beat.inflight, beat.t_mono))
        except error as exc:
            outcomes.append(('error', str(exc)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ('ok' if payload == 'beat' else 'error')
    # a port heartbeat crosses the wire and checks on arrival
    beat = transport_lib.decode_frame(transport_lib.encode_frame(
        ('heartbeat', -1, transport_lib.Heartbeat(inflight=1, t_mono=2.0))))
    assert transport_lib.check_heartbeat(beat[2]).inflight == 1


def test_clock_offset_keeps_the_minimum():
    for lib, _error in BOTH:
        clock = lib.ClockOffset()
        assert clock.offset == 0.0 and clock.samples == 0
        clock.observe(None, 5.0)
        for remote, local in ((10.0, 12.5), (20.0, 21.0), (30.0, 33.0)):
            clock.observe(remote, local)
        assert (clock.offset, clock.samples) == (1.0, 3)
