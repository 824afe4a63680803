"""The metric catalog: every metric name the port emits, with type, unit
and help text (the port's copy of ``code2vec_tpu/telemetry/catalog.py``,
trimmed to the names the port emits; each entry keeps the reference's
type and unit, and where the port's mechanism differs the help text says
what the port counts).

Two consumers: the Prometheus exporter derives its ``# HELP`` / ``# TYPE``
headers from it, and ``tests/test_torch_telemetry.py`` holds every name
emitted in ``code2vec_tpu_torch/`` (a string literal passed to
``.counter``/``.gauge``/``.timer``/``.scalar``/``.get``) to it.

Naming: ``<subsystem>/<metric>[_<unit>]``; ``_ms``, ``_s``, ``_total``,
``_per_sec``. Prometheus names are ``code2vec_<name with / -> _>``. A
series of one of several coexisting instances carries a label suffix,
``serving/shed_total{replica=r1}`` (``labeled``); the keys here stay
label-free and ``base_name`` strips the suffix.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

COUNTER = 'counter'
GAUGE = 'gauge'
TIMER = 'timer'
SCALAR = 'scalar'   # MetricsWriter.scalar tags (per-step JSONL series)


def _m(mtype: str, unit: str, help_text: str) -> Dict[str, str]:
    return {'type': mtype, 'unit': unit, 'help': help_text}


CATALOG: Dict[str, Dict[str, str]] = {
    # ---- step-phase breakdown (Trainer.fit) ----
    'step/batch_wait_ms': _m(TIMER, 'ms', 'Host wait for the next staged '
                             'batch (input pipeline starvation).'),
    'step/h2d_ms': _m(TIMER, 'ms', 'Enqueue of one batch\'s host->device '
                      'copy through pinned buffers on the staging ring\'s '
                      'side stream (asynchronous).'),
    'step/dispatch_ms': _m(TIMER, 'ms', 'Enqueue of the train step\'s '
                           'kernels (asynchronous on CUDA: a launch time, '
                           'not device time).'),
    'step/sync_ms': _m(TIMER, 'ms', 'Blocking device->host read of the '
                       'loss window (drains the dispatched steps).'),
    'step/total_ms': _m(TIMER, 'ms', 'Full hot-loop iteration (wait + '
                        'dispatch + callbacks).'),
    'step/pack_ms': _m(TIMER, 'ms', 'Host-side packing of one batch into '
                       'the packed wire format (reader/cache thread).'),
    # ---- throughput ----
    'train/steps_total': _m(COUNTER, 'steps', 'Train steps dispatched.'),
    'train/examples_total': _m(COUNTER, 'examples', 'Valid (weight>0) '
                               'examples consumed by train steps.'),
    'train/contexts_total': _m(COUNTER, 'contexts', 'Valid path-contexts '
                               'consumed by train steps.'),
    'train/examples_per_sec': _m(GAUGE, 'examples/s', 'Windowed training '
                                 'throughput (since last telemetry flush).'),
    'train/contexts_per_sec': _m(GAUGE, 'contexts/s', 'Windowed context '
                                 'throughput (since last telemetry flush).'),
    'train/epoch_wall_time_s': _m(GAUGE, 's', 'Wall time of the last '
                                  "epoch's training loop (includes interval "
                                  'evals; excludes epoch-end eval/save).'),
    # ---- MFU / roofline (telemetry/goodput.py, telemetry/stepcost.py) ----
    'train/mfu': _m(GAUGE, 'fraction', 'Model FLOP utilization of the last '
                    'flush window: executed train-step FLOPs (analytic '
                    'count of the dispatched shapes, telemetry/stepcost.py) '
                    '/ (train seconds x DEVICE_PEAK_FLOPS x devices).'),
    'train/arithmetic_intensity': _m(GAUGE, 'flops/byte', 'FLOPs per byte '
                                     'accessed of the current train step '
                                     '(analytic count — the roofline '
                                     'x-axis).'),
    'train/step_flops': _m(GAUGE, 'flops', 'Logical FLOPs of one train '
                           'step at the current dispatch shape (analytic; '
                           'the kernels\' recompute not counted).'),
    'train/step_bytes': _m(GAUGE, 'bytes', 'Bytes one train step at the '
                           'current dispatch shape must move (analytic '
                           'estimate).'),
    # ---- staging ring ----
    'staging/ring_occupancy': _m(GAUGE, 'batches', 'Batches currently held '
                                 'in the device staging ring.'),
    'staging/ring_depth': _m(GAUGE, 'batches', 'Configured staging-ring '
                             'depth (DEVICE_PREFETCH_BATCHES; 0 on the '
                             'CPU).'),
    # ---- compilation (the port's: captures and kernel builds) ----
    'jit/compiles_total': _m(COUNTER, 'compiles', 'CUDA-graph captures and '
                             'kernel builds or loads in this process (the '
                             'port has no XLA compile).'),
    'jit/compile_ms': _m(TIMER, 'ms', 'Durations of CUDA-graph captures '
                         'and kernel builds or loads.'),
    'jit/respecializations_total': _m(COUNTER, 'compiles', 'New packed '
                                      'capacities of the step\'s shapes '
                                      'after the first, observed by the '
                                      'trainer.'),
    'jit/packed_capacity': _m(GAUGE, 'slots', 'Current packed-wire context '
                              'capacity bucket feeding the step.'),
    # ---- input pipeline ----
    'input/cache_hit_total': _m(COUNTER, 'caches', 'Token-cache opens that '
                                'found a fresh on-disk cache.'),
    'input/cache_miss_total': _m(COUNTER, 'caches', 'Token-cache opens that '
                                 'had to (re)build the cache.'),
    'input/batches_total': _m(COUNTER, 'batches', 'Batches emitted by the '
                              'host input pipeline.'),
    'input/packed_fill_rate': _m(GAUGE, 'fraction', 'Retained context slots '
                                 '/ packed wire capacity of the last packed '
                                 'batch (padding waste = 1 - this).'),
    # ---- serving engine (serving/engine.py) ----
    'serving/requests_total': _m(COUNTER, 'requests', 'Prediction requests '
                                 'submitted to the serving engine.'),
    'serving/batches_total': _m(COUNTER, 'batches', 'Coalesced '
                                'micro-batches dispatched to the device.'),
    'serving/queue_depth': _m(GAUGE, 'requests', 'Requests waiting in the '
                              'micro-batcher queue.'),
    'serving/batch_fill_rate': _m(GAUGE, 'fraction', 'Valid rows / bucket '
                                  'size of the last dispatched '
                                  'micro-batch.'),
    'serving/latency_ms': _m(TIMER, 'ms', 'Request latency: submit -> '
                             'decoded results (windowed percentiles).'),
    'serving/dispatch_ms': _m(TIMER, 'ms', 'Coalesce + pack + pinned copy '
                              '+ CUDA-graph replay enqueue of one '
                              'micro-batch.'),
    'serving/decode_ms': _m(TIMER, 'ms', 'Host wait for the outputs\' copy '
                            '+ top-k/attention decode of one micro-batch '
                            '(worker pool).'),
    'serving/warmup_s': _m(GAUGE, 's', 'Wall time of the CUDA-graph '
                           'ladder capture at engine load.'),
    'serving/programs_warm': _m(GAUGE, 'programs', 'Captured CUDA graphs '
                                '(bucket x capacity x tier x parameter '
                                'slot) resident after warmup.'),
    'serving/bulk_examples_per_sec': _m(GAUGE, 'examples/s', 'Streaming '
                                        'embedding-export throughput.'),
    'serving/shed_total': _m(COUNTER, 'requests', 'Requests rejected at '
                             'admission (queue bound, drain-estimate vs '
                             'deadline, or a reject_all drill).'),
    'serving/expired_total': _m(COUNTER, 'requests', 'Admitted requests '
                                'expired past their SLO deadline while '
                                'queued (never dispatched).'),
    'serving/degraded_total': _m(COUNTER, 'requests', 'Requests admitted '
                                 'at a downgraded output tier by the '
                                 'overload degradation ladder.'),
    'serving/overload_level': _m(GAUGE, 'level', 'Degradation ladder '
                                 'state: 0 normal, 1 full->attention, '
                                 '2 everything->topk.'),
    'serving/queue_peak_rows': _m(GAUGE, 'rows', 'High-water mark of '
                                  'admitted rows queued (vs the '
                                  'admission bound).'),
    'serving/rollover_total': _m(COUNTER, 'rollovers', 'Live checkpoint '
                                 'rollovers swapped in (canary passed '
                                 'or canary disabled).'),
    'serving/rollover_rollbacks_total': _m(COUNTER, 'rollovers',
                                           'Canaried rollovers rolled '
                                           'back (agreement below the '
                                           'floor, or timed out).'),
    'serving/rollover_agreement': _m(GAUGE, 'fraction', 'Top-1 agreement '
                                     '(candidate vs serving params) '
                                     'measured by the last canary.'),
    'serving/breaker_state': _m(GAUGE, 'state', 'Extractor circuit '
                                'breaker: 0 closed, 1 half-open, '
                                '2 open.'),
    'serving/breaker_open_total': _m(COUNTER, 'trips', 'Extractor '
                                     'circuit-breaker open transitions.'),
    'serving/extractor_retries_total': _m(COUNTER, 'retries', 'Extractor '
                                          'pool calls retried after a '
                                          'crash-class failure.'),
    # ---- serving mesh (serving/mesh.py, serving/frontqueue.py) ----
    'mesh/requests_total': _m(COUNTER, 'requests', 'Requests submitted '
                              'to the serving mesh front queue.'),
    'mesh/queue_depth': _m(GAUGE, 'requests', 'Requests waiting in the '
                           'shared mesh front queue (all tiers).'),
    'mesh/queue_rows': _m(GAUGE, 'rows', 'Rows admitted to the shared '
                          'front queue (the admission-bound basis).'),
    'mesh/shed_total': _m(COUNTER, 'requests', 'Requests shed at mesh '
                          'admission (all reasons).'),
    'mesh/shed_bound_total': _m(COUNTER, 'requests', 'Mesh sheds caused '
                                'by the shared queue bound.'),
    'mesh/shed_deadline_total': _m(COUNTER, 'requests', 'Mesh sheds '
                                   'caused by the fleet drain estimate '
                                   'exceeding the request deadline.'),
    'mesh/expired_total': _m(COUNTER, 'requests', 'Admitted mesh '
                             'requests expired past their SLO deadline '
                             'in the shared queue (never dispatched).'),
    'mesh/degraded_total': _m(COUNTER, 'requests', 'Mesh requests '
                              'admitted at a downgraded tier by the '
                              'shared-queue overload ladder.'),
    'mesh/replicas': _m(GAUGE, 'replicas', 'Replicas registered in the '
                        'mesh replica table.'),
    'mesh/replicas_serving': _m(GAUGE, 'replicas', 'Replicas currently '
                                'weighted into dispatch (not breaker-'
                                'open, not retired).'),
    'mesh/replicas_live': _m(GAUGE, 'replicas', 'Replicas currently '
                             'LIVE by the heartbeat verdict (not dead, '
                             'not retired) — distinct from dispatch '
                             'health: a breaker-open replica still '
                             'counts, a hung one does not.'),
    'mesh/dispatch_share': _m(GAUGE, 'fraction', 'Per-replica share of '
                              'all rows the mesh has dispatched '
                              '(replica-labeled series).'),
    'mesh/replica_breaker_open_total': _m(COUNTER, 'trips', 'Replica '
                                          'dispatch-breaker open '
                                          'transitions (consecutive '
                                          'dispatch failures).'),
    'mesh/rollover_total': _m(COUNTER, 'rollovers', 'Coordinated fleet '
                              'rollovers: canary passed on one replica, '
                              'every replica swapped.'),
    'mesh/rollover_rollbacks_total': _m(COUNTER, 'rollovers',
                                        'Coordinated rollovers rolled '
                                        'back by the canary replica '
                                        '(fleet kept the old params).'),
    'mesh/retired_total': _m(COUNTER, 'replicas', 'Replicas permanently '
                             'retired from the fleet, plus a '
                             'reason-labeled series ({reason=drain|'
                             'autoscale|restart_budget|adopted_worker_'
                             'exit}).'),
    'mesh/restarts_total': _m(COUNTER, 'restarts', 'Supervised worker '
                              'restarts that rejoined the fleet '
                              '(re-adopted onto the current params '
                              'step before pulling).'),
    'mesh/redispatched_total': _m(COUNTER, 'requests', 'Requests '
                                  're-admitted at the queue FRONT '
                                  'after their batch died with its '
                                  'worker (once per request; a second '
                                  'crash fails typed).'),
    'mesh/heartbeat_misses_total': _m(COUNTER, 'intervals', 'Heartbeat '
                                      'intervals worker replicas were '
                                      'observed past due (budget '
                                      'MESH_HEARTBEAT_MISSES marks the '
                                      'replica dead).'),
    'mesh/clock_offset_ms': _m(GAUGE, 'ms', 'Estimated monotonic-clock '
                               'offset of one worker incarnation vs '
                               'the mesh (replica-labeled; min-filter '
                               'over heartbeat samples — remote span '
                               'stamps shift by this at stitching).'),
    'mesh/worker_snapshots_total': _m(COUNTER, 'snapshots', 'Worker '
                                      'telemetry/ledger snapshots '
                                      'merged replica-labeled into the '
                                      'fleet registry off heartbeats.'),
    'mesh/adopted_total': _m(COUNTER, 'workers', 'Workers started outside '
                             'the mesh and adopted into the fleet off a '
                             'dial-in the mesh did not spawn (checks '
                             'passed, moved to the fleet\'s step; their '
                             'orchestrator owns their restarts).'),
    'mesh/adoption_rejected_total': _m(COUNTER, 'workers', 'Adoption '
                                       'dial-ins rejected after the hello: '
                                       'duplicate rid, ready timeout, or a '
                                       'capability mismatch (tiers, wire); '
                                       'the worker gets a typed '
                                       'adopt_rejected frame.'),
    # ---- autoscaler (serving/autoscaler.py) ----
    'autoscale/replicas_target': _m(GAUGE, 'replicas', 'Fleet size the '
                                    'autoscaler currently wants (within '
                                    'AUTOSCALE_MIN/MAX_REPLICAS).'),
    'autoscale/scale_up_total': _m(COUNTER, 'transitions', 'Autoscaler '
                                   'scale-ups that seated a replica (or '
                                   'asked the spawn hook for one): drain '
                                   'estimate over AUTOSCALE_UP_QUEUE_SECS, '
                                   'or an SLO burn over '
                                   'AUTOSCALE_UP_BURN.'),
    'autoscale/scale_up_failed_total': _m(COUNTER, 'transitions',
                                          'Scale-ups whose spawn or seat '
                                          'failed (counted, not fatal; '
                                          'the up-cooldown applies before '
                                          'the retry).'),
    'autoscale/scale_down_total': _m(COUNTER, 'transitions', 'Autoscaler '
                                     'scale-downs: the newest eligible '
                                     'replica drained and retired '
                                     '{reason=autoscale} after the '
                                     'sustained-idle window.'),
    'autoscale/flap_freezes_total': _m(COUNTER, 'freezes', 'Flap-guard '
                                       'trips: too many direction '
                                       'reversals inside '
                                       'AUTOSCALE_FLAP_WINDOW_SECS froze '
                                       'all scaling for one window.'),
    # ---- memoization tier (serving/memo.py) ----
    'memo/hits_total': _m(COUNTER, 'requests', 'Requests served from '
                          'the exact memo tier at mesh admission (no '
                          'device work, no queue slot).'),
    'memo/misses_total': _m(COUNTER, 'requests', 'Memo lookups that '
                            'missed and went to the live serving '
                            'path.'),
    'memo/inserts_total': _m(COUNTER, 'results', 'Delivered-good '
                             'results inserted into the exact memo '
                             'tier.'),
    'memo/evictions_total': _m(COUNTER, 'entries', 'LRU entries evicted '
                               'under the MEMO_CACHE_BYTES budget '
                               '(generation bumps invalidate without '
                               'counting here).'),
    'memo/bytes': _m(GAUGE, 'bytes', 'Host bytes held by cached memo '
                     'results (exact + semantic tiers; mirrors the '
                     'ledger memo bucket).'),
    'memo/entries': _m(GAUGE, 'entries', 'Entries resident in the exact '
                       'memo tier.'),
    'memo/semantic_hits_total': _m(COUNTER, 'requests', 'Neighbor '
                                   'queries served by the semantic '
                                   'tier from a within-epsilon cached '
                                   'query.'),
    'memo/semantic_agreement': _m(GAUGE, 'fraction', 'Running top-1 '
                                  'agreement of shadow-sampled '
                                  'semantic hits vs their live '
                                  'results.'),
    # ---- SLO burn-rate monitor (serving/slo.py) ----
    'slo/availability_burn_fast': _m(GAUGE, 'ratio', 'Availability '
                                     'error-budget burn rate over the '
                                     'fast window (1.0 = burning '
                                     'exactly the budget).'),
    'slo/availability_burn_slow': _m(GAUGE, 'ratio', 'Availability '
                                     'error-budget burn rate over the '
                                     'slow window.'),
    'slo/p99_burn_fast': _m(GAUGE, 'ratio', 'p99-latency error-budget '
                            'burn rate over the fast window (share of '
                            'requests slower than SERVING_SLO_P99_MS '
                            'vs the 1% budget).'),
    'slo/p99_burn_slow': _m(GAUGE, 'ratio', 'p99-latency error-budget '
                            'burn rate over the slow window.'),
    'slo/good_total': _m(COUNTER, 'requests', 'Requests counted good '
                         'by the SLO monitor (delivered, within the '
                         'latency target when one is set).'),
    'slo/bad_total': _m(COUNTER, 'requests', 'Requests counted against '
                        'the availability budget (shed, expired, '
                        'failed).'),
    'slo/slow_total': _m(COUNTER, 'requests', 'Delivered requests '
                         'slower than SERVING_SLO_P99_MS (counted '
                         'against the latency budget).'),
    'slo/alerts_total': _m(COUNTER, 'alerts', 'SLO burn alerts fired '
                           '(both windows over '
                           'SERVING_SLO_BURN_THRESHOLD; dumps '
                           'flight_slo_burn.jsonl).'),
    # ---- training goodput plane (telemetry/goodput.py) ----
    'goodput/productive_s': _m(GAUGE, 's', 'Cumulative wall seconds of '
                               'productive train-step time this run '
                               '(fit wall minus typed badput).'),
    'goodput/badput_s': _m(GAUGE, 's', 'Cumulative badput seconds, '
                           'kind-labeled: {kind=compile|input_wait|'
                           'checkpoint|eval|rewind|rewind_replay|preempt|'
                           'warmup}.'),
    'goodput/fraction': _m(GAUGE, 'fraction', 'Goodput: productive '
                           'seconds / fit wall seconds so far.'),
    'goodput/anomalies_total': _m(COUNTER, 'anomalies', 'Step-time anomaly '
                                  'watchdog fires: sustained regression '
                                  'past GOODPUT_ANOMALY_SIGMA robust '
                                  'deviations of the dispatch shape\'s '
                                  'rolling median (dumps '
                                  'flight_step_anomaly.jsonl).'),
    'goodput/autocaptures_total': _m(COUNTER, 'captures', 'Anomaly-'
                                     'triggered profiler captures armed '
                                     '(rate-limited to one per '
                                     'GOODPUT_AUTOCAPTURE_COOLDOWN_SECS).'),
    # ---- profiler capture ----
    'trace/captures_total': _m(COUNTER, 'captures', 'On-demand '
                               'torch.profiler trace captures completed.'),
    # ---- per-request serving traces (telemetry/tracing.py) ----
    'tracing/traces_total': _m(COUNTER, 'traces', 'Per-request serving '
                               'traces completed (sampled or not).'),
    'tracing/retained_total': _m(COUNTER, 'traces', 'Traces written to '
                                 'the span log: head-sampled, or '
                                 'tail-retained (shed/expired/degraded/'
                                 'split/closed/slow).'),
    'tracing/flight_dumps_total': _m(COUNTER, 'dumps', 'Flight-recorder '
                                     'ring dumps (flight_<event>.jsonl: '
                                     'overload burst, canary rollback, '
                                     'close).'),
    'tracing/adopted_spans_total': _m(COUNTER, 'spans', 'Remote worker '
                                      'span records grafted into live '
                                      'parent traces by adopt_spans '
                                      '(cross-process stitching).'),
    'tracing/remote_spans_dropped_total': _m(COUNTER, 'spans', 'Remote '
                                             'span records that could '
                                             'not be stitched: their '
                                             'dispatch was no longer '
                                             'pending or the trace had '
                                             'already finished.'),
    # ---- embedding index (index/; the index rollover metrics are the
    # mesh's rollover_index: ROADMAP A17) ----
    'index/build_s': _m(GAUGE, 's', 'Wall time of the last store / IVF '
                        'build.'),
    'index/vectors_total': _m(GAUGE, 'vectors', 'Vectors resident in the '
                              'loaded index store.'),
    'index/shard_rows': _m(GAUGE, 'rows', 'Store rows resident on the '
                           'device (exact tier; one shard until the mesh, '
                           'ROADMAP A9).'),
    'index/warmup_s': _m(GAUGE, 's', 'Wall time of the query-bucket '
                         'warm-up run at index load (nothing compiles).'),
    'index/queries_total': _m(COUNTER, 'queries', 'Neighbor queries '
                              'answered by the index.'),
    'index/query_latency_ms': _m(TIMER, 'ms', 'Index search latency per '
                                 'query batch (dispatch + fetch + '
                                 'merge).'),
    'index/queries_per_sec': _m(GAUGE, 'queries/s', 'Streaming batch '
                                'neighbor-query throughput '
                                '(--query-neighbors).'),
    'index/probe_fanout': _m(GAUGE, 'candidates', 'Mean candidate rows '
                             'scanned per query by the IVF probe '
                             '(nprobe lists, pre-padding).'),
    'index/recall_at10': _m(GAUGE, 'fraction', 'Measured IVF recall@10 '
                            'vs the exact tier on a held-out query '
                            'sample.'),
    'index/segments': _m(GAUGE, 'segments', 'Uncompacted append '
                         'segments live in the quantized tier.'),
    'index/append_rows': _m(GAUGE, 'rows', 'Inserted vectors queryable '
                            'from the append buffer, not yet folded '
                            'into the base lists.'),
    'index/inserts_total': _m(COUNTER, 'vectors', 'Vectors inserted '
                              'live into the quantized tier since '
                              'load.'),
    'index/compactions_total': _m(COUNTER, 'compactions', 'Append-'
                                  'segment compactions folded into the '
                                  'base CSR (no k-means rebuild).'),
    'index/compact_s': _m(GAUGE, 's', 'Wall time of the last '
                          'compaction (lock held: inserts/searches '
                          'block for this long).'),
    # ---- device-memory ledger (telemetry/memory.py) ----
    'mem/params_bytes': _m(GAUGE, 'bytes', 'Ledger-attributed device '
                           'bytes held by model parameter sets (one '
                           'entry per set: the trainer\'s fp32 masters, '
                           'each serving engine parameter slot).'),
    'mem/opt_state_bytes': _m(GAUGE, 'bytes', 'Ledger-attributed '
                              'optimizer-state (Adam moment) bytes.'),
    'mem/staging_bytes': _m(GAUGE, 'bytes', 'Bytes held by batches '
                            'resident in the device staging ring.'),
    'mem/index_bytes': _m(GAUGE, 'bytes', 'Bytes held by embedding-'
                          'index residents (exact store rows, IVF '
                          'rows + centroids, quantized codes per '
                          'segment).'),
    'mem/executables_bytes': _m(GAUGE, 'bytes', 'Bytes of the serving '
                                'engine\'s shared CUDA-graph memory pool '
                                '(memory_snapshot segments), measured at '
                                'warm-up; excluded from array '
                                'reconciliation.'),
    'mem/memo_bytes': _m(GAUGE, 'bytes', 'Host bytes held by the '
                         'serving memoization tier (bucket memo, '
                         'kind=host; excluded from array '
                         'reconciliation: nothing on the card).'),
    'mem/attributed_bytes': _m(GAUGE, 'bytes', 'Sum of all array-kind '
                               'ledger entries (the reconciliation '
                               'numerator).'),
    'mem/unattributed_bytes': _m(GAUGE, 'bytes', 'Backend live bytes '
                                 'minus attributed — the residual the '
                                 'reconciliation keeps honest.'),
    'mem/backend_live_bytes': _m(GAUGE, 'bytes', 'Backend-reported '
                                 'live device bytes '
                                 '(torch.cuda.memory_allocated; reserved '
                                 'and free bytes ride in snapshots).'),
    'mem/watermark_bytes': _m(GAUGE, 'bytes', 'High-water mark of '
                              'attributed bytes since process start.'),
    'mem/budget_bytes': _m(GAUGE, 'bytes', 'Effective HBM_BUDGET_BYTES '
                           '(0 = unlimited).'),
    'mem/oom_dumps_total': _m(COUNTER, 'dumps', 'oom_ledger.json '
                              'forensic dumps written on '
                              'torch.cuda.OutOfMemoryError or a '
                              'budget-exceeded refusal.'),
    'mem/snapshots_total': _m(COUNTER, 'snapshots', 'Ledger snapshots '
                              'written (MEM_NOW, --memory-report, '
                              'forensic dumps).'),
    # ---- resilience (resilience/) ----
    'resilience/rewinds_total': _m(COUNTER, 'rewinds', 'Divergence-guard '
                                   'rewinds: non-finite loss windows that '
                                   'triggered a checkpoint restore.'),
    'resilience/faults_fired_total': _m(COUNTER, 'faults', 'Injected faults '
                                        'fired by the FAULT_INJECT plan '
                                        '(nonzero only in fault drills).'),
    'resilience/preempt_save_s': _m(GAUGE, 's', 'Duration of the final '
                                    'snapshot save after a preemption '
                                    'signal (SIGTERM/SIGINT).'),
    'watchdog/armed': _m(GAUGE, 'bool', 'Hang watchdog state: 1 while the '
                         'hot loop is inside a watched blocking wait.'),
    'watchdog/expired_total': _m(COUNTER, 'expiries', 'Watchdog deadline '
                                 'expiries (stack dump + hard abort; >0 '
                                 'at most once per process).'),
    # ---- MetricsWriter scalar tags (per-step JSONL series) ----
    'train/loss': _m(SCALAR, 'nats', 'Windowed average training loss.'),
    'eval/top1_acc': _m(SCALAR, 'fraction', 'Top-1 exact-match accuracy.'),
    'eval/subtoken_f1': _m(SCALAR, 'fraction', 'Subtoken F1.'),
    'eval/subtoken_precision': _m(SCALAR, 'fraction', 'Subtoken precision.'),
    'eval/subtoken_recall': _m(SCALAR, 'fraction', 'Subtoken recall.'),
    'eval/wall_time_s': _m(SCALAR, 's', 'Wall time of one full evaluation '
                           'pass.'),
}
# train/examples_per_sec and train/epoch_wall_time_s double as
# MetricsWriter scalar tags (model_api.train's on_log / on_epoch_time).


#: instance-label suffix: one {key=value} trailer on a catalog name
_LABEL_RE = re.compile(r'^(?P<base>[^{]+)\{(?P<key>\w+)=(?P<val>[^}]*)\}$')


def label_suffix(key: str, value: str) -> str:
    """The ``{key=value}`` trailer a labeled series appends to its
    catalog name (``core.ScopedRegistry`` applies it)."""
    return '{%s=%s}' % (key, value)


def labeled(name: str, key: str, value: str) -> str:
    """``('serving/shed_total', 'replica', 'r1')`` ->
    ``'serving/shed_total{replica=r1}'``."""
    return name + label_suffix(key, value)


def base_name(name: str) -> str:
    """Catalog key of a possibly-labeled metric name."""
    match = _LABEL_RE.match(name)
    return match.group('base') if match else name


def split_label(name: str) -> Tuple[str, Optional[Tuple[str, str]]]:
    """``'m{replica=r1}'`` -> ``('m', ('replica', 'r1'))``; label-free
    names return ``(name, None)``."""
    match = _LABEL_RE.match(name)
    if match is None:
        return name, None
    return match.group('base'), (match.group('key'), match.group('val'))


def prometheus_name(name: str) -> str:
    """Catalog name -> Prometheus metric name (``m{replica=r1}`` ->
    ``code2vec_m{replica="r1"}``)."""
    base, label = split_label(name)
    prom = 'code2vec_' + base.replace('/', '_').replace('.', '_')
    if label is not None:
        prom += '{%s="%s"}' % label
    return prom
