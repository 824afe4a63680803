"""A serving mesh worker started outside the mesh (the port of
``scripts/mesh_worker.py``).

An orchestrator (a host list, k8s, a drill) runs it to add capacity to a
running socket-mode mesh without the mesh spawning anything::

    python -m code2vec_tpu_torch.serving.mesh_worker --address HOST:PORT \\
        --load PATH [--rid RID] [--tiers topk,vectors] \\
        [--heartbeat-secs S] [--config-json FILE] [--device {cuda,cpu}] \\
        [--device-indices 1]

The worker dials the mesh's listener at ``--address``, builds its model
from the checkpoint store on its device, warms its ladder, reports ready
and serves the framed wire: its serve loop is the mesh's own
``serving/mesh.py::_replica_worker_main``, which this module only hands
a config. Its rid is one the mesh never spawned, so the mesh adopts it:
it checks the wire protocol, the batch wire format and the warm tiers,
moves it to the fleet's step and gives it a puller, or refuses it with a
typed ``adopt_rejected`` frame. Restarts stay with the orchestrator: if
this process dies, the mesh retires its slot without charging its own
restart budget, and running this module again is the restart.

It dials first and then cold-starts, as a worker the mesh spawned does,
so the mesh's adoption wait (``ServingMesh.adopt_ready_timeout_s``)
covers the cold start.

``--config-json`` is a JSON object of Config field overrides, the shape
the mesh ships to the workers it spawns (``ServingMesh._worker_overrides``);
the flags override its entries. The worker never saves, trains or follows
checkpoints: a rollover reaches it over the wire. Its telemetry
backhaul follows ``MESH_TELEMETRY_BACKHAUL`` in that object: at 1 its
heartbeats carry its spans, registry snapshot and memory-ledger rollup
into the mesh's fleet view; at 0, or at -1 (AUTO is resolved by the mesh
when it spawns a worker, and this one it did not spawn), its beats carry
liveness only. ``--device`` (default
``cuda``) is where it runs; with no card and no ``--device cpu`` it exits
non-zero with its reason before it dials. ``--device-indices`` (the
reference's flag; MESH_DEVICE_INDICES) is its placement slice, one card
in the port: it pins itself to that card before its first CUDA call
(``parallel/mesh.py::pin_to_slice``) and reports the card and its UUID
in its ready frame, which the mesh records as the slot's slice; a pin
that fails exits non-zero with its reason before it dials.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def parse_address(text: str):
    host, _, port = text.rpartition(':')
    if not host or not port.isdigit():
        raise argparse.ArgumentTypeError('expected HOST:PORT, got %r' % text)
    return host, int(port)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m code2vec_tpu_torch.serving.mesh_worker',
        description='a serving mesh worker started outside the mesh: dials '
                    'a socket-mode ServingMesh listener and serves the '
                    'dispatch wire until closed or killed')
    parser.add_argument('--address', required=True, type=parse_address,
                        help='the mesh listener, HOST:PORT')
    parser.add_argument('--rid', default=None,
                        help='the replica id to introduce itself as '
                             '(default ext-<pid>); unique in the fleet')
    parser.add_argument('--load', default=None,
                        help='the checkpointed model path (at least one '
                             'retained step); required unless --config-json '
                             'carries MODEL_LOAD_PATH')
    parser.add_argument('--config-json', default=None,
                        help='a JSON file of Config field overrides; the '
                             'flags here override its entries')
    parser.add_argument('--tiers', default=None,
                        help='the tiers to warm (SERVING_WARM_TIERS); they '
                             'must cover the mesh\'s, or the adoption is '
                             'refused')
    parser.add_argument('--heartbeat-secs', type=float, default=None,
                        help='the liveness beat period (MESH_HEARTBEAT_SECS), '
                             'the mesh\'s')
    parser.add_argument('--device-indices', default=None,
                        help='this worker\'s placement slice: the index of '
                             'its card in torch.cuda\'s numbering (sets '
                             'MESH_DEVICE_INDICES)')
    parser.add_argument('--device', choices=['cuda', 'cpu'], default='cuda',
                        help="where to run: 'cuda' (default) or 'cpu' (the "
                             'kernels\' plain versions)')
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    overrides = {}
    if args.config_json:
        with open(args.config_json) as handle:
            overrides = dict(json.load(handle))
    if args.load:
        overrides['MODEL_LOAD_PATH'] = args.load
    if args.tiers:
        overrides['SERVING_WARM_TIERS'] = args.tiers
    if args.heartbeat_secs is not None:
        overrides['MESH_HEARTBEAT_SECS'] = args.heartbeat_secs
    if args.device_indices:
        overrides['MESH_DEVICE_INDICES'] = args.device_indices
    overrides['DEVICE'] = args.device
    if not overrides.get('MODEL_LOAD_PATH'):
        parser.error('a worker restores its weights from a checkpoint '
                     'store: pass --load PATH (or MODEL_LOAD_PATH in '
                     '--config-json)')
    # the worker serves: it never saves, trains or rolls on its own
    overrides['MODEL_SAVE_PATH'] = ''
    overrides['TRAIN_DATA_PATH_PREFIX'] = ''
    overrides['SERVE_FOLLOW_CHECKPOINTS_SECS'] = 0.0
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.parallel import mesh as parallel_mesh
    pinned = None
    try:
        indices = overrides.get('MESH_DEVICE_INDICES')
        if indices:
            # before the first CUDA call of this process
            slice_ = parallel_mesh.parse_device_indices(str(indices))
            pinned = (slice_, parallel_mesh.pin_to_slice(slice_))
        device_lib.resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print('mesh_worker: %s' % exc, file=sys.stderr)
        return 2
    rid = args.rid if args.rid else 'ext-%d' % os.getpid()
    from code2vec_tpu_torch.serving import mesh as mesh_lib
    # the one worker: the handshake, the wire and the fault sites of a
    # worker the mesh spawned
    mesh_lib._replica_worker_main(rid, overrides, None, args.address,
                                  pinned=pinned)
    return 0


if __name__ == '__main__':
    sys.exit(main())
