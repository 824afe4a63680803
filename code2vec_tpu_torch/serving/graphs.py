"""The serving engine's warm ladder: one captured CUDA graph per (batch
bucket, capacity rung, tier, parameter slot) — the counterpart of the
reference engine's ladder of jit programs (``code2vec_tpu/serving/
engine.py::ServingEngine.warmup``).

A JAX program takes its parameters and its batch as arguments; a CUDA
graph reads fixed addresses. So the ladder owns every tensor its graphs
read:

- **Parameter slots.** Compute-dtype copies of the weights, one or two.
  A rollover copies the candidate into the idle slot in place
  (``load_slot``: ``copy_`` keeps the addresses), the canary replays the
  idle slot's graph on the same inputs, and a swap only changes which
  slot serves — no capture after warm-up.
- **Static inputs**, one set per (bucket, rung): the packed wire's
  ``(ctx, count, label, weight)`` or the plane wire's six arrays. A
  dispatch copies its host batch into them; the graphs hold no data
  dependence on the counts (the ragged forward sizes its grid and
  scratch from the capacity and the batch only, and builds its pair map
  on the card), so one graph serves any counts at its shape.
- **One shared memory pool** (``torch.cuda.graph_pool_handle()``) for
  every graph's intermediates: at bucket 1024 the logits alone are ~1 GB,
  and a private pool per graph would hold tens of GB. Sharing is safe
  because every replay runs on one stream (``stream``), its enqueue is
  serialized by ``lock``, and its outputs are copied to pinned host
  buffers on that stream right after it, before any other replay.

Outputs leave through a ring of pinned host buffer sets per (bucket,
tier): the copy and an event are enqueued after the replay, and the
decode worker waits on the event (``Fetch.result``), copies the values
out and gives the set back. Inputs arrive the other way, through pinned
sets per (bucket, rung) whose reuse waits on the event of their last
copy.

On the CPU (``device='cpu'``) nothing is captured: ``warm`` plans the
same keys and ``run`` calls ``predict_step`` eagerly with the kernels'
plain versions. On the card a failed capture or launch raises; nothing
runs eagerly in a dispatch.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.serving.steps import predict_step
from code2vec_tpu_torch.telemetry import jit_tracker


class GraphKey(NamedTuple):
    bucket: int
    rung: int       # packed capacity; 0 on the plane wire
    tier: str
    slot: int


def key_name(key: GraphKey) -> str:
    return 'b%d/c%d/%s/s%d' % key


class PinnedSet:
    """One set of pinned host buffers and the event of the last copy that
    reads or writes them."""

    __slots__ = ('key', 'buffers', 'event')

    def __init__(self, key, buffers: Dict[str, torch.Tensor]):
        self.key = key
        self.buffers = buffers
        self.event = torch.cuda.Event()


class PinnedRing:
    """``depth`` pinned buffer sets per key, handed out in turn.
    ``acquire`` blocks while every set of the key is out, and waits for
    the event recorded on the set it returns, so a buffer is written
    again only after the copy that used it finished and its consumer
    released it."""

    def __init__(self, depth: int):
        self.depth = max(1, depth)
        self._free: Dict[object, List[PinnedSet]] = {}
        self._made: Dict[object, int] = {}
        self._cond = threading.Condition()

    def make(self, key, like: Dict[str, torch.Tensor]) -> None:
        """Allocate the key's sets, shaped as ``like``."""
        with self._cond:
            if key in self._made:
                return
            self._free[key] = [
                PinnedSet(key, {name: torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True)
                    for name, t in like.items()})
                for _ in range(self.depth)]
            self._made[key] = self.depth

    def acquire(self, key) -> PinnedSet:
        with self._cond:
            free = self._free[key]
            while not free:
                self._cond.wait()
            pset = free.pop()
        pset.event.synchronize()
        return pset

    def release(self, pset: PinnedSet) -> None:
        with self._cond:
            self._free[pset.key].append(pset)
            self._cond.notify_all()

    @property
    def nbytes(self) -> int:
        with self._cond:
            return sum(t.numel() * t.element_size()
                       for sets in self._free.values() for s in sets
                       for t in s.buffers.values())


class Fetch:
    """A dispatch's outputs on their way to the host. ``result`` waits for
    the copy, returns numpy copies of the values (of ``names`` only, when
    given) and gives the pinned set back to its ring (once; later calls
    return the same dict)."""

    def __init__(self, ring: Optional[PinnedRing] = None,
                 pset: Optional[PinnedSet] = None,
                 values: Optional[Dict[str, np.ndarray]] = None,
                 names: Optional[Sequence[str]] = None):
        self._ring = ring
        self._pset = pset
        self._values = values
        self._names = names

    def result(self) -> Dict[str, np.ndarray]:
        if self._values is None:
            pset = self._pset
            try:
                pset.event.synchronize()
                names = self._names or tuple(pset.buffers)
                self._values = {name: pset.buffers[name].numpy().copy()
                                for name in names}
            finally:
                self.release()
        return self._values

    def release(self) -> None:
        """Give the pinned set back without reading it (a failed
        dispatch)."""
        if self._pset is not None:
            pset, self._pset = self._pset, None
            self._ring.release(pset)


class Staged:
    """One dispatch between ``GraphLadder.stage`` and ``launch``: its host
    arrays and, on the card, its pinned input and output sets."""

    __slots__ = ('bucket', 'rung', 'tier', 'host_arrays', 'inputs', 'out',
                 'shadow')

    def __init__(self, bucket: int, rung: int, tier: str, host_arrays):
        self.bucket = bucket
        self.rung = rung
        self.tier = tier
        self.host_arrays = host_arrays
        self.inputs: Optional[PinnedSet] = None
        self.out: Optional[PinnedSet] = None
        self.shadow: Optional[PinnedSet] = None


class GraphLadder:
    """The (bucket x rung x tier) ladder over ``slots`` parameter slots of
    one backend, on its device."""

    def __init__(self, backend, wire: str, buckets: Sequence[int],
                 capacities: Dict[int, Tuple[int, ...]],
                 tiers: Sequence[str], params: Code2VecParams,
                 ring_depth: int = 4):
        self.backend = backend
        self.device = backend.device
        self.on_card = self.device.type == 'cuda'
        self.wire = wire
        self.buckets = tuple(buckets)
        self.capacities = dict(capacities)
        self.tiers = tuple(tiers)
        self.max_contexts = backend.config.MAX_CONTEXTS
        # orders every enqueue on `stream` (replays, output copies, slot
        # copies) and every capture after warm-up
        self.lock = threading.Lock()
        # guards the two count dicts (stats() reads them from any thread)
        self._count_lock = threading.Lock()
        self.slots: List[Code2VecParams] = []
        self.captures: Dict[GraphKey, int] = {}
        self.replays: Dict[GraphKey, int] = {}
        self._graphs: Dict[GraphKey, Tuple[torch.cuda.CUDAGraph,
                                           Dict[str, torch.Tensor]]] = {}
        self._inputs: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}
        self._warm_slots = 0
        if self.on_card:
            self.stream = torch.cuda.Stream(self.device)
            self._capture_stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
            self._out_ring = PinnedRing(ring_depth)
            self._in_ring = PinnedRing(2)
        _created, done = self.load_slot(0, params)
        if done is not None:
            done.synchronize()

    # ------------------------------------------------------------ plan
    def rungs(self, bucket: int) -> Tuple[int, ...]:
        return self.capacities[bucket] if self.wire == 'packed' else (0,)

    def keys(self) -> List[Tuple[int, int, str]]:
        """The planned (bucket, rung, tier) keys, in the reference
        engine's warm order (bucket, then capacity, then tier)."""
        return [(bucket, rung, tier) for bucket in self.buckets
                for rung in self.rungs(bucket) for tier in self.tiers]

    def _pad_batch(self, bucket: int, rung: int) -> Tuple[np.ndarray, ...]:
        """The all-PAD batch of a (bucket, rung): the static inputs'
        values at capture (graphs key on shapes, not values)."""
        backend = self.backend
        if self.wire == 'packed':
            ctx = np.empty((1, rung, 3), np.int32)
            ctx[..., 0] = backend.token_pad_index
            ctx[..., 1] = backend.path_pad_index
            ctx[..., 2] = backend.token_pad_index
            return (ctx, np.zeros((bucket,), np.int32),
                    np.zeros((bucket,), np.int32),
                    np.zeros((bucket,), np.float32))
        shape = (bucket, self.max_contexts)
        return (np.zeros(shape, np.int32), np.zeros(shape, np.int32),
                np.zeros(shape, np.int32), np.zeros(shape, np.float32),
                np.zeros((bucket,), np.int32),
                np.zeros((bucket,), np.float32))

    # ----------------------------------------------------------- slots
    def load_slot(self, slot: int, params: Code2VecParams
                  ) -> Tuple[bool, Optional[torch.cuda.Event]]:
        """Copy ``params`` into parameter slot ``slot`` in place, cast to
        the compute dtype; a slot one past the last is allocated. Returns
        ``(created, done)``: ``created`` when the slot is new (its graphs
        are still to be captured), ``done`` the event the copy completes
        at on the card (None on the CPU, where it is done on return). On
        the card the copy runs on ``stream`` after every replay enqueued
        before it and before every one enqueued after; ``params`` must
        stay alive until ``done``."""
        if slot > len(self.slots):
            raise ValueError('parameter slot %d past the %d slots'
                             % (slot, len(self.slots)))
        shapes = self.backend.param_shapes()
        for name in Code2VecParams._fields:
            shape = tuple(getattr(params, name).shape)
            if shape != shapes[name]:
                raise ValueError('parameter %s has shape %s, expected %s'
                                 % (name, shape, shapes[name]))
        created = slot == len(self.slots)
        with self.lock:
            if created:
                self.slots.append(Code2VecParams(*[
                    torch.empty(shapes[name], dtype=self.backend.dtype,
                                device=self.device)
                    for name in Code2VecParams._fields]))
            target = self.slots[slot]
            if not self.on_card:
                for dst, src in zip(target, params):
                    dst.copy_(src.detach())
                return created, None
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                for dst, src in zip(target, params):
                    dst.copy_(src.detach(), non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return created, done

    # ---------------------------------------------------------- warmup
    def warm(self, n_slots: int) -> int:
        """Capture every key for slots ``[0, n_slots)`` not captured yet
        (allocating the slots past the loaded ones from slot 0's
        values); returns the graphs captured. On the CPU it captures
        nothing and returns 0."""
        while len(self.slots) < n_slots:
            _created, done = self.load_slot(len(self.slots), self.slots[0])
            if done is not None:
                done.synchronize()
        if not self.on_card:
            self._warm_slots = max(self._warm_slots, n_slots)
            return 0
        with self.lock:
            start = self._warm_slots
            if start >= n_slots:
                return 0
            captured = 0
            torch.cuda.synchronize(self.device)
            for bucket in self.buckets:
                for rung in self.rungs(bucket):
                    inputs = self._inputs.get((bucket, rung))
                    if inputs is None:
                        inputs = tuple(torch.from_numpy(a).to(self.device)
                                       for a in self._pad_batch(bucket, rung))
                        self._inputs[(bucket, rung)] = inputs
                        self._in_ring.make(('in', bucket, rung), {
                            str(i): t for i, t in enumerate(inputs)})
                    for tier in self.tiers:
                        if start == 0:
                            # builds the kernels and every lazy state
                            # (cuBLAS workspace, shared-memory limits)
                            # before the first capture
                            with torch.cuda.stream(self._capture_stream):
                                predict_step(self.backend, inputs, tier,
                                             params=self.slots[0])
                            self._capture_stream.synchronize()
                        for slot in range(start, n_slots):
                            self._capture(GraphKey(bucket, rung, tier, slot),
                                          inputs)
                            captured += 1
            self._warm_slots = n_slots
        return captured

    def _capture(self, key: GraphKey, inputs) -> None:
        """One capture into the shared pool on the capture stream
        (``capture_begin``/``capture_end``: ``torch.cuda.graph`` would run
        a garbage collection and empty the cache before each of the
        ladder's ~140 captures). ``thread_local``: the dispatcher and the
        decode workers may keep working during a second slot's capture;
        an unsafe call on this thread still fails the capture. Each
        capture is one compile of the telemetry (``jit/compiles_total``).
        """
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._capture_stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode='thread_local')
            try:
                out = predict_step(self.backend, inputs, key.tier,
                                   params=self.slots[key.slot])
            finally:
                graph.capture_end()
        self._graphs[key] = (graph, out)
        with self._count_lock:
            self.captures[key] = self.captures.get(key, 0) + 1
        self._out_ring.make(('out', key.bucket, key.tier), out)
        jit_tracker.note_compile(time.perf_counter() - t0)

    @property
    def warm_slots(self) -> int:
        return self._warm_slots

    # --------------------------------------------------------- replays
    def stage(self, bucket: int, rung: int, tier: str,
              host_arrays: Sequence[np.ndarray], shadow: bool) -> 'Staged':
        """Take the pinned buffers one dispatch needs and write its host
        batch into them, outside every lock (this may wait for a decode
        worker to give a set back). ``shadow`` takes a second output set
        for the canary."""
        staged = Staged(bucket, rung, tier, host_arrays)
        if not self.on_card:
            return staged
        key = ('out', bucket, tier)
        if key not in self._out_ring._made:
            raise KeyError('no captured graph for bucket %d, tier %r '
                           '(warmed slots: %d)'
                           % (bucket, tier, self._warm_slots))
        staged.inputs = self._in_ring.acquire(('in', bucket, rung))
        for i, array in enumerate(host_arrays):
            staged.inputs.buffers[str(i)].numpy()[...] = array
        staged.out = self._out_ring.acquire(key)
        if shadow:
            staged.shadow = self._out_ring.acquire(key)
        return staged

    def abandon(self, staged: 'Staged') -> None:
        """Give back the sets of a dispatch that will not launch."""
        for name in ('inputs', 'out', 'shadow'):
            pset = getattr(staged, name)
            if pset is not None:
                setattr(staged, name, None)
                (self._in_ring if name == 'inputs'
                 else self._out_ring).release(pset)

    def launch(self, staged: 'Staged', slot: int,
               shadow_slot: Optional[int] = None
               ) -> Tuple[Fetch, Optional[Fetch]]:
        """The staged batch through the ``tier`` graph of ``slot`` and,
        with ``shadow_slot`` (and a shadow set staged), through that
        slot's graph too: the canary, whose fetch holds only the top-k
        indices. On the card the fetches complete asynchronously; on the
        CPU the step runs eagerly here."""
        bucket, rung, tier = staged.bucket, staged.rung, staged.tier
        if not self.on_card:
            arrays = tuple(torch.from_numpy(np.ascontiguousarray(a))
                           for a in staged.host_arrays)
            out = predict_step(self.backend, arrays, tier,
                               params=self.slots[slot])
            shadow = None
            if shadow_slot is not None:
                top = predict_step(self.backend, arrays, tier,
                                   params=self.slots[shadow_slot])
                shadow = Fetch(values={
                    'topk_indices': top['topk_indices'].numpy()})
            return Fetch(values={k: v.numpy() for k, v in out.items()}), \
                shadow
        key = GraphKey(bucket, rung, tier, slot)
        if shadow_slot is None or staged.shadow is None:
            shadow_slot = None
            if staged.shadow is not None:
                self._out_ring.release(staged.shadow)
                staged.shadow = None
        try:
            for k in ((key,) if shadow_slot is None
                      else (key, key._replace(slot=shadow_slot))):
                if k not in self._graphs:
                    raise KeyError('no captured graph for %s (warmed '
                                   'slots: %d)' % (key_name(k),
                                                   self._warm_slots))
            with self.lock, torch.cuda.stream(self.stream):
                for i, static in enumerate(self._inputs[(bucket, rung)]):
                    static.copy_(staged.inputs.buffers[str(i)],
                                 non_blocking=True)
                staged.inputs.event.record(self.stream)
                self._replay(key, staged.out, self._graphs[key][1].keys())
                if shadow_slot is not None:
                    self._replay(key._replace(slot=shadow_slot),
                                 staged.shadow, ('topk_indices',))
        except BaseException:
            self.abandon(staged)
            raise
        self._in_ring.release(staged.inputs)
        fetch = Fetch(self._out_ring, staged.out)
        shadow = (Fetch(self._out_ring, staged.shadow,
                        names=('topk_indices',))
                  if shadow_slot is not None else None)
        staged.inputs = staged.out = staged.shadow = None
        return fetch, shadow

    def _replay(self, key: GraphKey, pset: PinnedSet, names) -> None:
        """Replay one graph and enqueue its outputs' copy to ``pset``
        (caller holds ``lock``, on ``stream``)."""
        graph, out = self._graphs[key]
        graph.replay()
        with self._count_lock:
            self.replays[key] = self.replays.get(key, 0) + 1
        for name in names:
            pset.buffers[name].copy_(out[name], non_blocking=True)
        pset.event.record(self.stream)

    # ------------------------------------------------------ inspection
    def replay_ms(self, key: GraphKey, reps: int = 10) -> float:
        """Median device ms of one replay of ``key`` (CUDA events on
        ``stream``; a measurement, not counted as a replay)."""
        graph = self._graphs[key][0]
        times = []
        with self.lock, torch.cuda.stream(self.stream):
            for _ in range(reps + 2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(self.stream)
                graph.replay()
                end.record(self.stream)
                times.append((start, end))
            self.stream.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in times[2:]]))

    def pool_bytes(self) -> Optional[int]:
        """Bytes the shared pool holds (``torch.cuda.memory_snapshot``
        segments of the pool); None on the CPU or where the snapshot does
        not name pools."""
        if not self.on_card:
            return None
        total, named = 0, False
        for segment in torch.cuda.memory_snapshot():
            pool = segment.get('segment_pool_id')
            if pool is None:
                continue
            named = True
            if tuple(pool) == tuple(self.pool):
                total += int(segment['total_size'])
        return total if named else None

    def slot_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for slot in self.slots
                   for t in slot)

    def counts(self) -> Tuple[Dict[GraphKey, int], Dict[GraphKey, int]]:
        """Copies of the (captures, replays) per graph key."""
        with self._count_lock:
            return dict(self.captures), dict(self.replays)

    def stats(self) -> Dict[str, object]:
        captures, replays = self.counts()
        return {
            'graphs': len(self._graphs),
            'captures_total': sum(captures.values()),
            'replays_total': sum(replays.values()),
            'captures': {key_name(k): n for k, n in captures.items()},
            'replays': {key_name(k): n for k, n in replays.items()},
            'slots': len(self.slots), 'warm_slots': self._warm_slots,
            'slot_bytes': self.slot_bytes(),
            'pinned_bytes': (self._out_ring.nbytes + self._in_ring.nbytes
                             if self.on_card else 0),
        }

    def close(self) -> None:
        """Drop the graphs, the shared pool's tensors, the static inputs,
        the slots and the pinned sets (the counts stay for ``stats``);
        the caller has drained every dispatch."""
        with self.lock:
            if self.on_card:
                self.stream.synchronize()
            self._graphs.clear()
            self._inputs.clear()
            self.slots = []
            if self.on_card:
                self._out_ring = PinnedRing(self._out_ring.depth)
                self._in_ring = PinnedRing(self._in_ring.depth)
