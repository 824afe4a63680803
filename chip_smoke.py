#!/usr/bin/env python3
"""Smoke run of the PyTorch port (code2vec_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device — requires ``torch.cuda.is_available()``; prints the card's name
   and power limit (nvidia-smi);
2. build — compiles every hand-written kernel from the sources in this
   checkout into build/kernels/ (one nvcc per source, in parallel);
3. kernels — at the java14m width (d 128/128, D 384, B 1024, context counts
   with median ~28 and max 200, empty rows and interior holes), holds each
   kernel against its plain PyTorch version on the card, fp32 and bf16,
   and times both with CUDA events; the ragged forward also at the edges
   of its 64-slot tiles (examples of 0, 1, 63, 64, 65 and 200 slots, some
   starting at a tile edge, a partial last tile, interior holes, a tile
   whose every slot is invalid, two shards with slots past a shard's
   total, fp32 masters and bf16 tables with and without the keep mask, K
   and D of 128 and 256), its plan kernel's pair map against ``_pair_map``;
4. serving — ``Code2VecModel(device='cuda')`` at the java14m width (vocab
   1,301,136 / 911,417 / 261,245 synthetic words, weights from a seed, bf16
   compute) answers ``predict`` at batch buckets 8, 64 and 1024 on the
   topk, attention and vectors tiers. Launch counts are zeroed just before
   and read just after; every call must go through the ragged kernel and
   no other, and no operation of the path may run on the CPU; then
   ``ops/topk.py::top_k`` on tied logits against a numpy rule of
   ``lax.top_k``'s order, and what it costs the predict step at each
   bucket against ``torch.topk``;
5. reference — a small model on the card against the same weights on the
   CPU (plain versions): same top-k words, close scores and attention;
   then ``Code2VecModel.evaluate()`` over a 4,096-line synthetic
   ``.test.c2v`` (4 batches of 1024, working directory build/smoke/,
   where its log.txt lands): one ragged launch per batch;
6. plane wire — the same weights with ``BATCH_WIRE_FORMAT='planes'`` and
   ``USE_PALLAS_FUSED_ENCODE``: the fused context-transform kernel against
   its plain version at B 1024 x 200 contexts (rows without a valid
   context, all-PAD slots, row counts ending inside a tile or under one
   tile, and the other code dims on small inputs), fp32 and bf16, the
   fp32 kernel (three TF32 terms on the tensor cores) also against float64
   on 16,384 rows, within 4x of the plain version's own error, and for the
   same bits on two launches, timed beside the plain version and the
   cuBLAS route; predict at
   the three buckets and tiers and ``evaluate()``, each call or batch one
   encode launch and no other kernel, no CPU op; predict on the packed
   wire with ``USE_PALLAS_RAGGED_FUSION=False`` (unpacked on the card,
   then one encode launch); a small model evaluated in fp32 on the card
   and on the CPU: equal metrics and log.txt, close loss;
7. train kernels — at the java14m training shape (B 1024, fp32 master
   tables, dropout keep 0.75, target table 262,144 rows) holds the ragged
   forward in training mode, the ragged backward, and the CE forward and
   backward against their plain versions, fp32 and bf16, each part of a
   gradient on its own scale (the CE backward's label rows, other rows and
   softmax-only dcode; the ragged backward's de per example, and its de and
   dW against a float64 reference fed the kernel's own du), each also at
   the edges of its tiling: the ragged backward on streams with examples
   of 0, 1, 63, 64 and 65 slots, a partial last 64-slot tile, interior
   holes, bf16 tables without a mask over two shards, and K, D of 128 and
   256; the CE forward and backward at B 1000, labels at and past
   num_valid, num_valid inside a block, code dims 128 and 256. The fp32
   ragged forward and backward and CE kernels (three TF32 terms on the
   tensor cores) also against float64 (the forward's scores, m, z and acc
   and the backward on the whole batch, de also per example; the CE on 128
   rows over the whole table), each output within 4x of the plain
   version's own error, and for the same bits on two launches; the fp32
   forward also at its tile edges (an example across three tiles, the
   mask off and on, the given e stream, K = 96 with D = 192, D = 102 and
   D = 1024). Times them
   beside the materialized-logits route (cuBLAS) for the CE rows (bounds
   at the rate of the units each runs on), and the ragged forward at the
   training shape beside its own bound;
7b. optimizer kernels — the fused Adam kernel (``ops/csrc/adam.cu``)
   against its plain version on the card, bit for bit over every element
   of every java14m parameter, for each of the eight gradient x mu x nu
   dtype combinations, and on edge inputs (a length that is not a multiple
   of 8, streams one element past alignment and at offsets that never
   align together, steps 1 and 2, zero, +-3e38 and NaN gradients, updates
   that round to a signed zero); timed beside its bound, the plain version
   and, for fp32 moments, ``torch.optim.Adam(fused=True)``; lazy Adam's row
   kernel against its plain version over the token rows of a real packed
   batch plus one row listed 20,000 times and entries outside the table
   (untouched rows keep their bits), from the list and from a mask (a
   mesh's), timed beside ``torch.optim.SparseAdam``, the mark step and the
   row kernel also apart;
8. train — a ``Trainer`` at java14m width (USE_PALLAS_FUSED_CE, bf16, keep
   0.75) takes 20 steps on one pre-packed batch plus one under the CPU-op
   watch: the loss falls, every step launches each of the four kernels
   once and the Adam kernel once a parameter, no operation runs on the
   CPU; then a few steps with materialized logits, a step-time breakdown
   (forward, backward, Adam); the fp32 path (COMPUTE_DTYPE='float32', the
   fused CE, 10 steps plus one watched: the loss falls, the four kernels
   once a step, the step's median ms); then one short java14m phase per
   optimizer knob (LAZY_EMBEDDING_ADAM, GRADS_DTYPE='bfloat16', EMBED_GRAD_IMPL
   'sorted' and 'dedup', REMAT_ENCODE): the loss falls, no CPU op and no
   host sync on the steps, the expected launches (lazy: Adam once for each
   of the three dense parameters, the row kernel once a table), the step
   ms, whether the table gradients repeat bit for bit from one state, and
   under lazy Adam the PAD rows move on a batch whose only route to them is
   ``packed_rows``' append;
9. train entry — ``Code2VecModel(device='cuda').train()`` over a synthetic
   ``.train.c2v`` at java14m width, then a predict with the trained weights;
10. train reference — a small-vocabulary model at full width trains three
   steps on the card and on the CPU (plain versions) from the same weights
   and batches at keep 1.0, in fp32 and in bf16 (three draws of batches,
   each from its own generator): losses, Adam moments and weights agree;
11. checkpoints — at java14m width and vocabulary with the fused CE,
   ``Code2VecModel.train()`` saves after each of three short epochs
   (MAX_TO_KEEP=2, the oldest step removed), in a temporary directory under
   build/smoke/ that it removes: the newest step restores equal to the
   trained state, a params-only reload evaluates and predicts bit for bit
   as the model in memory, the release holds no moments and loads under the
   plain route's 261,248 target rows, and a resumed model's next epoch
   agrees with the model continued in memory within the bf16 train
   reference's limits (the table gradients' atomic adds differ in order);
   prints the save, restore and release times with GB and GB/s;
12. CLI — ``code2vec_tpu_torch.cli.main`` in process on the card: train
   with --fused-ce and --save, --load --test, --release, --save_word2v, at
   full width over a 5,000 / 3,000 / 1,000-word vocabulary;
13. host pipeline (after phase 5's evaluate) — the native tokenizer built
   with g++ (timed) and held equal to the Python reader on the 4,096 test
   lines; each reader's host ms per batch of 1024; ``evaluate()`` with the
   native reader and the staging ring against READER_USE_NATIVE=False:
   equal metrics and log.txt; for each the seconds, host read, device
   step, decode and the card's idle share; the staging ring at depths 0,
   2 and 4 over the same batches: each batch as the step's stream reads
   it equals its host arrays, the eval outputs are equal across depths;
14. train pipeline (after phase 9) — ``train()`` at java14m width and
   vocabulary (fused CE, bf16, keep 0.75) over a 32,768-line split: two
   epochs from the token cache, one with TRAIN_DATA_CACHE=False (native
   tokenizer and prefetch thread); the cache's build seconds and bytes,
   each epoch's median step interval (CUDA events) and median wait for the
   next staged batch beside a repeated-batch step; every step launches
   the four training kernels once; the staged host buffers are pinned;
15. source to shell (last) — the extractor built from extractor/src,
   Java files from scripts/gen_java_corpus.py, data/extract_driver.py and
   data/preprocess.py as subprocesses, then ``cli.main`` on the card: train
   one epoch at full width over the preprocessed vocabulary, ``--load
   --test``, and ``--predict`` with the shell's input scripted (one file,
   then exit): the turn launches the ragged forward once and no other
   kernel; prints the predicted names.

14b. dense routes (after phase 14, over its split and token cache) —
   ``Code2VecModel.train()`` at java14m width and vocabulary (fused CE,
   bf16, keep 0.75) on the plane wire (``--wire-format planes``, 64
   steps) and on the packed wire unpacked on the card
   (``--no-ragged-fusion``, 32 steps): every step launches ``ce_fwd`` and
   ``ce_bwd`` once and Adam once a parameter, no ragged or encode kernel;
   the plane wire's loss falls; each route's step interval, and its step
   on one repeated batch beside the packed ragged route's (CUDA events);
   the CE kernels' device ms as the plane step launches them
   (torch.profiler); one plane step at keep 1.0 through the CE kernels
   against the same step with the CE's plain versions (loss and every
   gradient part, the bf16 train reference's limits); a java14m step
   snapshot's save and rewind seconds;
12b. resilience drills (after phase 12) — full width over a 5,000 /
   3,000 / 1,000-word vocabulary, 4 steps an epoch, on the packed wire's
   kernels: ``nan_loss`` with step snapshots (one rewind, finite losses
   after), ``sigterm`` (a snapshot and PREEMPTED.json, a resume that goes
   on from its step, ``metrics.jsonl`` with ``train/loss`` under -tb),
   ``corrupt_snapshot`` (the restore falls back a step and quarantines
   the corrupt one), and ``hang_input`` under ``--watchdog-secs`` in a CLI
   subprocess, which ends by SIGABRT with ``watchdog_stacks.txt`` naming
   the hung frame;

16. serving engine (after phase 13, on phase 4's model; the plane-wire
   engine after phase 6's evaluate) — two checkpoints of the weights
   saved under build/smoke/ (removed after) for the engine's param source;
   ``model.serving_engine()`` captures the default ladder (buckets 8, 64,
   512, 1024 x their capacity rungs x tiers topk, attention, full x two
   parameter slots: 138 CUDA graphs; warm seconds, the shared pool's
   bytes); the engine against ``Code2VecModel.predict`` bit for bit at
   each bucket and tier on light, java14m and heavy rows with count-0
   and all-PAD rows, then the same cases in a shuffled key order; one
   bucket-8 request's p50 through both; 8 caller threads for 3 s (topk,
   then mixed tiers): requests/s, rows/s, p50/p99, mean fill, the card's
   idle share, no capture after warm-up, beside the naive ``predict``
   loop over the same requests (the engine must not be slower); a
   torch.profiler trace of dispatches naming the ragged forward's
   kernels; rollover to a saved step (swap), to a perturbed set
   (rollback) and a vectors-only canary on a second engine (timeout), no
   capture, results during each canary equal the serving slot's; the
   overload drill (``slow_dispatch``, bound 8 rows, 60 ms deadline:
   typed sheds and expiries, admitted results bit for bit); and
   ``close(drain=True)``. On the plane wire: one slot, the same parity,
   2 s of load and a trace naming the encode kernel;
16b. engine telemetry (after phase 16, the same model) — telemetry on and
   per-request tracing at rate 1.0 on a topk ladder of one slot, 40
   requests: every trace in ``spans.jsonl`` with its device-execute span,
   ``jit/compiles_total`` flat after warm-up, ``mem/executables_bytes``
   equal to the graph pool's bytes;
16c. the embedding index (after phase 16's plane-wire engine, on phase
   4's model; D 384, in a directory under build/smoke/ that it removes) —
   the bulk feed: 65,536 lines at the java14m fill through
   ``serving/bulk.py::iter_code_vector_batches`` (64 batches of 1024, one
   ragged launch each) into a labeled float16 store, examples/s, the
   first batch equal to ``predict``'s vectors tier (rtol 2e-5 / atol
   1e-6), ``export_code_vectors`` text equal to the stream; the exact
   tier over 1,048,576 rows of a seeded clustered generator plus the bulk
   rows, float16: ``mem/index_bytes``, warm-up s, latency per query
   bucket (1, 8, 64, 512; k = 10; host clock and CUDA events), parity
   against numpy fp32 on 64 queries (scores within 1e-5, equal ids
   wherever neighbouring scores are more than 1e-5 apart),
   ``search_streamed`` equal to the resident search, recall@10 of the
   float16 store against a float32 one >= 0.97; IVF, int8 and PQ (M =
   96, re-rank 128) over 524,288 of the rows (float32 store, the default
   lists): k-means twice with identical ``ivf.npz`` contents, PQ training
   s, recall@10 at nprobe 8 (>= 0.95 for the quantized tiers), full probe
   with full re-rank against exact, bytes/vector, latency per bucket as
   host fill / device (CUDA events around the probe) / host total; 4,096
   inserts each its own nearest neighbour at once, then ``compact()`` bit
   for rank with the appended index and a fresh build; a topk+vectors
   engine with the exact index attached: ``predict_neighbors`` equal to
   the search of ``predict``'s vectors, 8 threads x 2 s of
   ``predict_neighbors`` (rows/s, p50/p99, no capture after warm-up, no
   wrapper launch); and ``cli.main`` over the small vocabulary:
   ``--build-index`` from a ``.c2v``, then ``--query-neighbors``, whose
   JSONL equals a direct ``query_neighbors_file``;
16d. the serving mesh (after phase 16c, on phase 4's model and phase 6's
   plane-wire model; two checkpoints of the weights, steps 0 and 1, under
   build/smoke/, removed after) — ``model.serving_mesh()`` at java14m
   width, bf16, the packed wire and the default ladder: 2 replicas and 1
   replica, each replica its own ladder of 138 CUDA graphs (warm
   seconds, captures, the ledger's slot and pool bytes per replica); the
   mesh against ``predict`` bit for bit at buckets 8 and 64; 8 caller
   threads x 2 s of topk requests of 1-64 java14m-fill lines on 2
   replicas, 1, 1, 2 (A B B A): rows/s, client p50/p99, rows and mean
   fill per replica, the card's idle share, no capture after warm-up, no
   wrapper launch; the same on 2 replicas with the attention and full
   tiers in the mix; a 2-replica mesh with the memo (64 MiB) and the SLO
   monitor on: 5 s with half the requests repeats whose contexts are
   permuted (hit share, live and cached rows/s; every answer from the
   memo equal to the first one bit for bit); under traffic, a
   coordinated swap to step 1 (every replica adopts, the memo generation
   bumps) and a rollback of a candidate whose target rows are permuted
   (every replica stays on step 1), no capture; ``retire('r1')`` under
   traffic (it stops pulling, no request fails); ``close(drain=True)``;
   then 2 plane-wire replicas (encode kernel): parity and 2 s of load;
16e. the mesh's worker modes (after phase 16d, the same models) — the
   java14m model saved once under build/smoke/ (removed after), then
   ``serving_mesh(mode='process')``: 2 spawned worker processes of the
   port, each with its own CUDA context, model restored from the
   checkpoint and ladder of 138 graphs (captures, none after warm-up, the
   ragged forward's launches of its warm-up counted in the worker and
   read over the wire, its memory), 1 ``mode='socket'`` replica and 1
   plane-wire process replica (the encode kernel), all started together;
   answers bit for bit ``predict``'s at buckets 8 and 64; 8 caller
   threads x 2 s of topk through 2 process replicas, 2 thread replicas
   and 1 replica, run A B C C B A (rows/s, p99, the card's idle share); a
   worker SIGKILLed mid-batch under traffic (every request answered, the
   redispatch count), the fleet rolled to a step saved while it is down
   and a newer step saved after, the restart (after a 10 s backoff)
   adopting the fleet's step before it pulls, its time to rejoin; after
   ``close()`` no worker pid alive and the card's used memory back
   within 1 GiB;
16f. the elastic fleet (after phase 16e, phase 4's model saved again) — a
   ``mode='socket'`` mesh of 1 worker with the autoscaler armed
   (AUTOSCALE_MAX_REPLICAS 2, driven by ``tick()``) and ``slow_dispatch``
   in its workers: a backlog of 1024-line requests, ``tick()`` reading
   the drain estimate and scaling up (r1 spawned, warmed, seated); the
   port's ``mesh_worker`` module started as a subprocess (``--rid
   ext-smoke``) cold-starting meanwhile; r0 SIGKILLed mid-batch, every
   admitted request answered bit for bit as ``predict`` answers it, r0
   restarted; ext-smoke adopted at the fleet's step and serving bit for
   bit, then killed (retired ``'adopted_worker_exit'``, no restart
   charged); a wrong-proto dial-in refused typed; once idle ``tick()``
   drains r1 out (``'autoscale'``) and the fleet still serves bit for
   bit; no capture after warm-up in any worker, each worker's warm-up
   launches read over the wire; after ``close()`` no worker alive and
   the card's used memory back within 1 GiB;
16g. fleet observability (after phase 16f) — socket meshes with the
   worker backhaul on and off: spans stitched across a worker's kill and
   restart, the fleet's Prometheus export, worker memory, the backhaul's
   cost (``mesh_backhaul_phase``);
16h. the scenario traffic plane (after phase 16g, phase 4's model) — a
   thread mesh of 2 replicas (topk and vectors, a 64 MiB memo, SLO
   targets on) with an ``ExactIndex`` over the bulk feed's 65,536 code
   vectors; a mixed Java and C# profile from ``build_synthetic_profile``
   through the checkout's extractor with predict, blend and neighbor
   records: recorded through ``record_traffic``, saved and read back,
   replayed unpaced twice at one seed (the same fingerprint and report)
   and one request at a time twice (bit for bit the same results); then
   repeated with fresh lines and paced, 4 s at 200 requests/s (kept up
   with) and at 600 (above what the fleet keeps up with), then at 600
   against an index that answers without searching: the offered and
   delivered rates, the backlog, p50/p99, shed, exact and F1 per scenario
   and language, the searches each completion thread ran;
   ``submit_blended`` with no index (the typed fallback), at weight 0
   (bit for bit topk) and 0.5 (bit for bit ``blend_row`` over its own
   legs) and its added latency; index rollovers that swap (an IVF
   candidate: neighbor entries invalidated, predict entries kept), roll
   back and fail; no capture after warm-up, this process's allocated
   bytes and the card's memory back after ``close()``
   (``workloads_phase``). Alone: ``python3 chip_smoke.py workloads-phase
   [--rate-scales 1,3] [--seconds 10] [--runs 1]``;
16i. placement (after phase 16h, phase 4's model saved once) — socket
   workers with MESH_DEVICES_PER_REPLICA=1, each pinned to a card of its
   own (one on a one-card host, two where there are two or more), started
   together with an unplaced socket worker, topk tier: each placed worker
   reports the card of its slice and the UUID this process sees there,
   its reserved bytes beside ROADMAP C9's +9.43 GB, and answers bit for
   bit as the unplaced worker on the same requests; one slice more than
   the cards is refused typed at build (``mesh_serve_phase``). Alone:
   ``python3 chip_smoke.py mesh-serve-phase``;
17. the (data, model) mesh (last; ``mesh_train_phase``) — 4 rank
   processes of a (2, 2) mesh (``chip_smoke.py mesh-train-rank``), over
   nccl with a card each where the host has 4, else over gloo, all on
   this card (then every collective is a host copy and its time claims
   nothing); java14m width and vocabulary, bf16, fused CE: each B7 route
   (the ragged forward and backward routes, whose gather kernel takes a
   row range, and the sharded CE's forward, backward and weighted sums)
   on one rank's shard against the one-rank route on the same global
   batch and keep mask; the CE kernels against their plain versions
   where shard 1 holds padding alone (finite merged lse, zero gradient
   rows); ``sharded_top_k`` against ``top_k`` on the same logits, index
   for index, and the eval step's top-1 agreement; each route's ms and
   its plain version's; then ``Code2VecModel.train()`` on the mesh (2
   epochs of 4 steps over a 4,096-line split): every step launches the
   four training kernels and the gather kernel once, and Adam once a
   parameter, on every rank, the loss falls, the replicated
   weights end bit for bit equal on every rank; ``evaluate()`` on the
   mesh; the (2, 2) checkpoint restored on one rank on this card with
   equal params and moments (digests); step interval and peak memory a
   rank; ``train()`` with TELEMETRY on: each rank's ``metrics``,
   ``.prom`` and ``intervals`` files (``.proc<r>`` for r > 0) and a
   finite ``train/mfu``. The training knobs on every rank
   (``mesh_knob_checks``): SHARD_CONTEXTS on the plane wire (code and
   encoder gradients against the unsharded mesh route on one global
   batch and keep mask; ``evaluate()`` through the encode kernel on the
   rank's context slice, with and without the knob; the encode kernel on
   a slice's rows against its plain version; a step at C = 1024 with and
   without the knob, peak allocated bytes); 'zero' against 'mirror', 4
   steps from one state, params and gathered moments bit for bit equal,
   moment and peak bytes; lazy Adam against the one-rank lazy step on the
   same global batch (``RESUME_LIMITS``), ``adam_rows`` twice a step,
   rows no rank touched unchanged, the row kernel over the mesh's row
   list bit for bit its plain version; fp32: the B7a/b routes against the
   one-rank fp32 route and their plain versions, the gather kernel's
   fp32 stream against its plain version (one fp32 rounding of the keep
   division), two fp32 ``train()`` steps
   launching every kernel. The serving paths on every rank of the trained
   mesh model (``mesh_serve_checks``): the bulk export of a 2,520-line
   corpus (20 lines without a valid context, a short final batch whose
   second data shard is padding only) on the packed wire, the ragged
   forward and the gather kernel once a batch on every rank, against the
   one-rank export of the restored checkpoint in corpus order;
   ``predict`` of 200 lines on the plane wire through the encode kernel,
   equal on every rank, its top-1 agreement with one rank's; an exact
   index of 1,048,576 f16 rows sharded over the data axis, a rank's
   resident bytes, its ids equal to the one-rank index's. Alone:
   ``python3 chip_smoke.py mesh-train-phase``;
14c. telemetry (after phase 14b, in a process of its own so the memory
   ledger reconciles against this run's allocations alone) — ``cli.main``
   trains one 128-step epoch at java14m width and vocabulary (fused CE,
   bf16, keep 0.75) with ``--telemetry --trace-at-step 8
   --memory-report``: the peak is the H100 row of the table, each flush
   window's ``train/mfu`` finite and those after the first within
   MFU_RANGE, ``scripts/goodput_report.py --json`` one run span with under
   2% of its wall unattributed, the capture naming the ragged forward and
   backward, ``ce_fwd``, ``ce_bwd`` and ``adam_update`` kernels, the ledger
   at the step-50 flush holding exactly the state's bytes (3.072 GB) with
   under 10% of the card's live bytes unattributed; then an OOM inside
   ``Trainer.fit`` (``oom_ledger.json``, raised again) and an
   HBM_BUDGET_BYTES one byte under the state refusing the model before it
   allocates;
2b. lint (after the build) — the port's static analysis
   (``code2vec_tpu_torch/analysis``) over this checkout: the rule count,
   the findings and the seconds; any finding neither suppressed nor
   baselined fails (``lint_phase``). Alone: ``python3 chip_smoke.py
   lint-phase``;
8b. the benchlib headline step (after the optimizer knobs) — the java14m
   step through ``code2vec_tpu_torch/benchlib.py``: ``build_trainer(
   headline_config(JAVA14M))`` with the fused CE, bf16, full
   ``random_batches`` packed to one capacity and staged through the
   trainer's ring, 10 warm-up and 60 steps timed by ``bench_timer``
   (median ms, examples/s and the ratio to the reference's V100
   4,700/s), every step launching the four training kernels once and
   Adam once a parameter, ``kernels_engaged`` of one more step,
   ``device_memory_record()``, the wire bytes of a batch at JAVA14M_FILL
   packed and as planes (packed fewer), and one eval step of
   ``build_eval_trainer``: the ragged forward once, no moment bytes
   allocated (``benchlib_phase``; its launches under ``benchlib`` in
   ``launches_by_path``). Alone: ``python3 chip_smoke.py
   benchlib-phase``.

Phase 5's and the later ``evaluate()`` and ``train()`` calls read through
the native tokenizer (and ``train()`` from the token cache), the defaults.

Prints a JSON line with each kernel's numbers (``launches_by_path``: its
launches on each main path, the checkpoint, CLI, host data path
(``eval_native``, ``train_cache``, ``train_native``), source and shell
(``repl``) paths among them, ``train_<knob>`` for the optimizer knobs, and
``train_planes``/``train_unpack`` the dense routes', ``telemetry`` the
telemetry phase's, ``resilience`` the
drills', ``engine``/``engine_planes``: the engine's warm-up runs and
captures, ``index_build`` the bulk feed's and the CLI's index builds,
``index_query`` the CLI's neighbor queries, ``engine_neighbors`` the
neighbor engine's warm-up, ``mesh``/``mesh_planes`` the serving meshes'
warm-ups, ``mesh_process``/``mesh_process_planes`` the worker processes'
warm-ups, counted in each worker, ``mesh_elastic`` the elastic fleet's
workers' (the autoscaler's, the restart's and the adopted one's),
``mesh_backhaul`` the backhaul phase's workers', ``workloads`` the traffic
plane's mesh warm-up, ``mesh_placed`` the placed workers' warm-ups,
``mesh_serve`` the serving paths on the mesh's ranks (the bulk export's
ragged forward, predict's encode kernel; summed), ``mesh_train`` the
training mesh's ranks (summed),
``mesh_shard_contexts``, ``mesh_zero``, ``mesh_lazy`` and ``mesh_fp32``
its knobs' paths, ``benchlib`` the benchlib headline steps'; the fp32
records' (``ragged_bwd_fp32``, ``ce_fwd_fp32``, ``ce_bwd_fp32``) the fp32
training paths' (``train_fp32``, ``mesh_fp32``), and ``encode_fp32``'s
the card's fp32 plane-wire ``evaluate()`` (``eval_planes_fp32``);
the B7 routes' records carry ``launches`` (the kernel launches of the
route's first kernel on the mesh's main path, summed over the ranks),
``launches_by_kernel`` (every kernel the route launches),
``launches_by_rank`` and ``ms_by_rank``;
``graph_replays_by_path``: the engine's replays of graphs that hold the
kernel, which no launch counter sees), the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import re
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / 'build' / 'smoke'
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
PEAK_FLOPS = {'bfloat16': 989e12,   # dense tensor cores
              'float32': 67e12,     # fp32 outside the tensor cores
              # fp32 as three TF32 products on the tensor cores (the fp32
              # CE, encode and ragged backward kernels): the dense TF32
              # rate over three
              'tf32x3': 495e12 / 3}
BUCKETS = ((8, 5), (64, 50), (1024, 1000))   # (bucket, lines sent)
TIERS = ('topk', 'attention', 'vectors')
TRAIN_STEPS = 20


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError('chip_smoke: ' + message)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()``: captured once in a CUDA graph
    and replayed, so the Python of the wrapper around a kernel does not
    leave the card idle inside the timed window
    (``benchlib.bench_cuda_ms``)."""
    from code2vec_tpu_torch.benchlib import bench_cuda_ms
    return bench_cuda_ms(fn, reps=reps, warmup=warmup)


def eager_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one eager call, host work included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


SUBTOKENS = ('get', 'set', 'is', 'to', 'add', 'run', 'make', 'read')


def target_word(i: int) -> str:
    """Synthetic method name i: letters only, two subtokens joined by
    ``|`` (a legal prediction, with subtokens that other names share)."""
    j, letters = i // len(SUBTOKENS), ''
    while True:
        j, r = divmod(j, 26)
        letters = chr(ord('a') + r) + letters
        if j == 0:
            return SUBTOKENS[i % len(SUBTOKENS)] + '|' + letters


def write_dict(path: Path, n_tokens: int, n_paths: int,
               n_targets: int) -> None:
    """A ``.dict.c2v`` of synthetic words t<i>, p<i> and target_word(i),
    counts descending so the vocab order is the index order."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'wb') as f:
        for words in (['t%d' % i for i in range(n_tokens)],
                      ['p%d' % i for i in range(n_paths)],
                      [target_word(i) for i in range(n_targets)]):
            pickle.dump({w: len(words) - i for i, w in enumerate(words)}, f)
        pickle.dump(0, f)


def context_counts(rng, batch: int, max_contexts: int) -> np.ndarray:
    """java14m-like fill: median ~28, a tail up to max_contexts."""
    counts = np.exp(rng.normal(math.log(28.0), 0.8, batch))
    counts = np.clip(np.rint(counts), 1, max_contexts).astype(np.int64)
    counts[rng.choice(batch, 4, replace=False)] = max_contexts
    return counts


def make_lines(rng, n: int, vocab_sizes, max_contexts: int,
               counts=None) -> list:
    """``n`` lines of random words at the java14m fill, or with the given
    context ``counts``."""
    n_tok, n_path, n_tgt = vocab_sizes
    lines = []
    if counts is None:
        counts = context_counts(rng, n, max_contexts)
    for count in counts:
        src = rng.integers(0, n_tok, count)
        pth = rng.integers(0, n_path, count)
        tgt = rng.integers(0, n_tok, count)
        ctxs = ' '.join('t%d,p%d,t%d' % triple
                        for triple in zip(src, pth, tgt))
        lines.append('%s %s' % (target_word(int(rng.integers(0, n_tgt))),
                                ctxs))
    return lines


def plane_batch(rng, batch: int, max_contexts: int, token_rows: int,
                path_rows: int, token_pad: int, path_pad: int, counts=None):
    """One plane batch at the serving shape: random indices, a few empty
    rows (no valid context), ~3% interior all-PAD holes; or the given
    per-example ``counts`` (with the same holes)."""
    from code2vec_tpu_torch.data.reader import Batch, context_valid_mask
    if counts is None:
        counts = context_counts(rng, batch, max_contexts)
        counts[rng.choice(batch, 8, replace=False)] = 0
    source = rng.integers(1, token_rows, (batch, max_contexts))
    path = rng.integers(1, path_rows, (batch, max_contexts))
    target = rng.integers(1, token_rows, (batch, max_contexts))
    cols = np.arange(max_contexts)[None, :]
    dead = cols >= counts[:, None]
    dead |= (rng.random((batch, max_contexts)) < 0.03) & (
        cols < counts[:, None] - 1)
    source[dead] = token_pad
    target[dead] = token_pad
    path[dead] = path_pad
    source, path, target = (a.astype(np.int32) for a in (source, path,
                                                         target))
    mask = context_valid_mask(source, path, target, token_pad, path_pad)
    return Batch(source=source, path=path, target=target, mask=mask,
                 label=np.zeros(batch, np.int32),
                 weight=np.ones(batch, np.float32))


def kernel_batch(rng, batch: int, max_contexts: int, token_rows: int,
                 path_rows: int, token_pad: int, path_pad: int):
    """``plane_batch`` packed onto the wire."""
    from code2vec_tpu_torch.data import packed as packed_lib
    return packed_lib.pack_batch(
        plane_batch(rng, batch, max_contexts, token_rows, path_rows,
                    token_pad, path_pad), token_pad, path_pad)


def worst(*values) -> float:
    """The largest of ``values``, NaN if any is NaN (Python's ``max``
    drops a NaN that is not first)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def max_err(got, want) -> float:
    return worst(*(float((g - w).abs().max()) for g, w in zip(got, want)))


def kernel_phase(model, rng, gpu: str) -> dict:
    """Hold the ragged kernel against its plain version at the serving
    shape; returns the kernel's JSON record (launches filled in later)."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    backend = model.backend
    config = model.config
    tpad, ppad = backend.token_pad_index, backend.path_pad_index
    packed = kernel_batch(rng, 1024, config.MAX_CONTEXTS,
                          model.vocabs.token_vocab.size,
                          model.vocabs.path_vocab.size, tpad, ppad)
    ctx = torch.from_numpy(packed.ctx).cuda()
    count = torch.from_numpy(packed.count).cuda()
    retained = int(packed.count.sum())
    segs = ragged._segment_inputs(ctx, count, tpad, ppad)
    fwd_record = None
    for dtype, params in (('float32', backend.params),
                          ('bfloat16', backend.compute_params)):
        tdtype = getattr(torch, dtype)
        args = (params.token_embedding, params.path_embedding,
                params.transform, params.attention.reshape(-1))
        kernel_stats = ragged._stats_kernel(*args, segs, tpad, ppad)
        plain_stats = ragged._stats_plain(*args, segs, tpad, ppad)
        kw = dict(max_contexts=config.MAX_CONTEXTS, token_pad=tpad,
                  path_pad=ppad, dtype=tdtype)
        full_args = (params.token_embedding, params.path_embedding,
                     params.transform, params.attention, ctx, count)
        kernel_out = ragged.ragged_encode(*full_args, **kw)
        plain_out = ragged.ragged_encode(*full_args, plain=True, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(('scores', 'm', 'z', 'acc'), kernel_stats,
                              plain_stats):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                       msg=lambda m, n=name: '%s %s: %s' % (
                                           dtype, n, m))
        if dtype == 'float32':
            torch.testing.assert_close(kernel_out, plain_out, rtol=1e-4,
                                       atol=1e-5)
        else:
            torch.testing.assert_close(kernel_out, plain_out, rtol=0,
                                       atol=1e-2)
        for t in kernel_out:
            check(bool(torch.isfinite(t).all()), 'non-finite kernel output')
        err = max_err(kernel_out, plain_out)
        edge_errs = ragged_fwd_edge_cases(backend.params, dtype, tpad, ppad)
        print('kernel ragged_fwd %s edge cases (scores, m, z, acc within '
              'rtol 1e-4, atol 1e-5): max |diff| %s [%s]'
              % (dtype, {k: float('%.3g' % v) for k, v in edge_errs.items()},
                 gpu))
        run_kernel = lambda: ragged._stats_kernel(*args, segs, tpad, ppad)
        run_plain = lambda: ragged._stats_plain(*args, segs, tpad, ppad)
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        # second reading in the other order: the spread of the two
        plain_ms2, ms2 = cuda_ms(run_plain), cuda_ms(run_kernel)
        eager = eager_ms(run_kernel)
        # least work: each input read once, each output written once
        elt = 2 if dtype == 'bfloat16' else 4
        k_dim, d_code = params.transform.shape
        batch = count.numel()
        bytes_moved = (retained * (k_dim * elt + 12)       # rows + triples
                       + (k_dim + 1) * d_code * elt        # W, attention
                       + ctx.shape[1] * 4                  # scores
                       + batch * (2 + d_code) * 4)         # m, z, acc
        flops = retained * (2 * k_dim * d_code + 4 * d_code)
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        # fp32 at the rate of the units it runs on: three TF32 products
        t_ops = flops / PEAK_FLOPS['tf32x3' if dtype == 'float32'
                                   else dtype] * 1e3
        print('kernel ragged_fwd %s: B=%d slots=%d max_abs_err=%.3g '
              'kernel %.4f/%.4f ms, plain %.4f/%.4f ms (device, graph '
              'replay, two readings), kernel eager call %.4f ms, bound '
              '%.4f ms (%s) [%s]'
              % (dtype, batch, retained, err, ms, ms2, plain_ms, plain_ms2,
                 eager, max(t_bytes, t_ops),
                 'bytes' if t_bytes >= t_ops else 'operations', gpu))
        if dtype == 'bfloat16':    # the serving path's compute dtype
            fwd_record = record(
                'ragged_fwd', 'code2vec_tpu_torch/ops/csrc/ragged_fwd.cu',
                'code2vec_tpu/ops/pallas_ragged.py:150', err, ms, plain_ms,
                max(t_bytes, t_ops),
                'bytes' if t_bytes >= t_ops else 'operations', None)
    return fwd_record


def library_encode(src, pth, tgt, w, attn):
    """One cuBLAS route over the concatenated rows, in the compute dtype:
    what the reference computes outside its TPU kernel."""
    import torch
    x = torch.tanh(torch.cat([src, pth, tgt], dim=1) @ w)
    return x, x @ attn


# encode kernel against its plain version, each output on its own scale
# (max |diff| over max |plain|). In bf16 both sum exact products of the
# same inputs in fp32 (the bf16 products are exact in fp32, the plain
# version runs fp32 cuBLAS with TF32 off), so they differ only in the
# order of a 384-term sum, ~1e-6 of the scale. In fp32 the kernel forms
# each product in three TF32 terms (lo.lo, ~2^-22 of a product, dropped;
# the sums 32 of K at a time), ~1e-6 of the scale from the plain
# version's exact fp32 products (encode_float64_checks holds both against
# float64). A wrong tile, chunk or tail row reads at the full scale.
ENCODE_LIMIT = 1e-4


# the fp32 encode against float64 (encode_float64_checks): the first
# ENCODE_F64_ROWS rows of the plane wire's batch; each output's error may
# be at most F64_FACTOR times the plain fp32 version's own
ENCODE_F64_ROWS = 16384


def encode_float64_checks(rows, w, attn) -> dict:
    """The fp32 encode kernel (three TF32 terms) and its plain version
    (fp32 cuBLAS, TF32 off) against float64 on the first ENCODE_F64_ROWS
    rows: each output's error (max |diff| over max |float64|) of the kernel
    may be at most F64_FACTOR times the plain version's. Returns {output:
    (kernel error, plain error)}."""
    import torch
    from code2vec_tpu_torch.ops import encode
    part = tuple(r[:ENCODE_F64_ROWS] for r in rows)
    x64 = torch.tanh(torch.cat(part, dim=1).double() @ w.double())
    want = (x64, x64 @ attn.double().reshape(-1, 1))
    readings = {}
    for tag, fn in (('kernel', encode._transform_kernel),
                    ('plain', encode._transform_plain)):
        got = fn(*part, w, attn)
        torch.cuda.synchronize()
        for name, g, v in zip(('x', 'scores'), got, want):
            readings.setdefault(name, {})[tag] = float(
                (g.double() - v).abs().max() / v.abs().max())
    for name, r in readings.items():
        check(r['kernel'] <= F64_FACTOR * r['plain'],
              'encode fp32 %s against float64: kernel %.3g, more than %.0fx '
              'the plain version\'s %.3g' % (name, r['kernel'], F64_FACTOR,
                                              r['plain']))
    return {name: (r['kernel'], r['plain']) for name, r in readings.items()}


def encode_kernel_phase(model, rng, gpu: str) -> list:
    """Holds the fused context-transform kernel against its plain version
    at the plane wire's shape (B 1024 x 200 contexts, every slot: rows
    with no valid context, all-PAD slots, holes), fp32 and bf16, plus row
    counts that end inside a tile or stay under one and the kernel's
    other code dims (128, 256) on small inputs; the fp32 kernel (three
    TF32 terms) also against float64 and for the same bits on two
    launches; times it beside the plain version and the library route.
    Returns the JSON records: bf16 (the serving main path), then fp32."""
    import torch
    from code2vec_tpu_torch.ops import encode
    backend = model.backend
    config = model.config
    tpad, ppad = backend.token_pad_index, backend.path_pad_index
    batch = plane_batch(rng, config.TEST_BATCH_SIZE, config.MAX_CONTEXTS,
                        model.vocabs.token_vocab.size,
                        model.vocabs.path_vocab.size, tpad, ppad)
    check(int((batch.mask.sum(axis=1) == 0).sum()) == 8,
          'the kernel batch has no row without a valid context')
    planes = [torch.from_numpy(a).cuda().long().reshape(-1)
              for a in (batch.source, batch.path, batch.target)]
    n = planes[0].numel()
    records = {}
    for dtype, params in (('float32', backend.params),
                          ('bfloat16', backend.compute_params)):
        tdtype = getattr(torch, dtype)
        rows = (params.token_embedding[planes[0]].to(tdtype),
                params.path_embedding[planes[1]].to(tdtype),
                params.token_embedding[planes[2]].to(tdtype))
        w = params.transform.to(tdtype)
        attn = params.attention.to(tdtype)
        args = rows + (w, attn)
        errs = {}
        # row counts ending inside the bf16 kernel's 128-row tile: in the
        # second consumer's 64 rows (n - 13 = 1,599 x 128 + 115), in the
        # first consumer's (1,000 x 128 + 37: the second has no row), and
        # fewer rows than one tile
        for label, cut in (('all rows', n), ('tail', n - 13),
                           ('first half of a tile', 128 * 1000 + 37),
                           ('under one tile', 100)):
            part = tuple(r[:cut] for r in rows) + (w, attn)
            got = encode._transform_kernel(*part)
            want = encode._transform_plain(*part)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  'non-finite encode kernel output')
            for name, g, v in zip(('x', 'scores'), got, want):
                check(g.shape == v.shape and g.dtype == torch.float32,
                      'encode %s %s: shape %s dtype %s'
                      % (dtype, name, tuple(g.shape), g.dtype))
                errs['%s %s' % (label, name)] = scaled_err([g], [v])
            if label == 'all rows':
                abs_err = max_err(got, want)
            del got, want
        # the kernel's other instantiations (code dims 128 and 256), at a
        # row count ending inside a tile
        for d_code in (128, 256):
            small = [torch.from_numpy(rng.uniform(-0.3, 0.3, shape).astype(
                np.float32)).cuda().to(tdtype) for shape in (
                    (1000, 64), (1000, 32), (1000, 64), (160, d_code),
                    (d_code, 1))]
            got = encode._transform_kernel(*small)
            want = encode._transform_plain(*small)
            torch.cuda.synchronize()
            for name, g, v in zip(('x', 'scores'), got, want):
                errs['D=%d %s' % (d_code, name)] = scaled_err([g], [v])
        err = worst(*errs.values())
        check(err <= ENCODE_LIMIT, 'encode %s disagrees with its plain '
              'version: scaled errors %s, limit %.3g'
              % (dtype, errs, ENCODE_LIMIT))
        run_kernel = lambda: encode._transform_kernel(*args)
        run_plain = lambda: encode._transform_plain(*args)
        run_library = lambda: library_encode(*rows, w, attn)
        ms, plain_ms, lib_ms = (cuda_ms(run_kernel), cuda_ms(run_plain),
                                cuda_ms(run_library))
        # second reading in the other order: the spread
        lib_ms2, plain_ms2, ms2 = (cuda_ms(run_library), cuda_ms(run_plain),
                                   cuda_ms(run_kernel))
        elt = 2 if dtype == 'bfloat16' else 4
        k_dim, d_code = w.shape
        enc_bytes = (n * k_dim * elt                        # the three rows
                     + (k_dim + 1) * d_code * elt           # W, attention
                     + n * (d_code + 1) * 4)                # x, scores
        enc_flops = 2.0 * n * (k_dim + 1) * d_code
        # the bound at the rate of the units the kernel runs on: fp32 as
        # three TF32 products on the tensor cores, the CUDA-core bound
        # printed beside it
        units = 'tf32x3' if dtype == 'float32' else dtype
        b_ms, b_by = bound(enc_bytes, enc_flops, units)
        extra = ''
        if dtype == 'float32':
            check(same_bits(lambda: encode._transform_kernel(*args)),
                  'encode float32: two launches differ')
            f64 = encode_float64_checks(rows, w, attn)
            extra = (', three-term TF32 at %.0f TFLOP/s; on the CUDA cores '
                     '%.4f ms; the same bits on two launches; against '
                     'float64 (%d rows; kernel, plain: max |diff| over max '
                     '|float64|, the kernel within %.0fx) %s'
                     % (PEAK_FLOPS[units] / 1e12,
                        bound(enc_bytes, enc_flops, 'float32')[0],
                        ENCODE_F64_ROWS, F64_FACTOR,
                        {k: (float('%.3g' % a), float('%.3g' % b))
                         for k, (a, b) in f64.items()}))
        print('kernel encode %s: N=%d rows (B=%d x C=%d, %d rows without a '
              'valid context) K=%d D=%d max_abs_err=%.3g, scaled errors %s '
              '(limit %.3g) kernel %.4f/%.4f ms, plain %.4f/%.4f ms, library '
              '(cat + cuBLAS + tanh + score) %.4f/%.4f ms (device, graph '
              'replay, two readings), bound %.4f ms (%s%s) [%s]'
              % (dtype, n, batch.source.shape[0], batch.source.shape[1],
                 int((batch.mask.sum(axis=1) == 0).sum()), k_dim, d_code,
                 abs_err, {k: float('%.3g' % v) for k, v in errs.items()},
                 ENCODE_LIMIT, ms, ms2, plain_ms, plain_ms2, lib_ms, lib_ms2,
                 b_ms, b_by, extra, gpu))
        # bf16: the serving and eval compute dtype; fp32: evaluate() and
        # predict at COMPUTE_DTYPE float32
        records[dtype] = record(
            'encode' if dtype == 'bfloat16' else 'encode_fp32',
            'code2vec_tpu_torch/ops/csrc/encode.cu',
            'code2vec_tpu/ops/pallas_encode.py:49', abs_err, ms, plain_ms,
            b_ms, b_by, lib_ms)
        del rows, args
        torch.cuda.empty_cache()
    return [records['bfloat16'], records['float32']]


class CpuOpWatch:
    """Records every tensor operation that computes on the CPU: all its
    tensor outputs on the CPU, a CPU tensor among its inputs or no inputs
    at all, and an output that is not a view of an input (wrapping a
    host array, as ``torch.from_numpy`` does, computes nothing) and holds
    an element (``torch.utils.checkpoint`` makes a 0-element CPU tensor as
    an autograd anchor: nothing is computed). Copies to and from the card
    pass."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        watch = self
        self.cpu_ops = []

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                import torch
                ins = [t for t in tree_leaves((args, kwargs or {}))
                       if isinstance(t, torch.Tensor)]
                outs = [t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
                in_storages = {t.untyped_storage().data_ptr() for t in ins}
                if outs and all(t.device.type == 'cpu' for t in outs) and (
                        not ins or any(t.device.type == 'cpu' for t in ins)
                ) and not all(t.untyped_storage().data_ptr() in in_storages
                              for t in outs) and any(t.numel() for t in outs):
                    watch.cpu_ops.append(str(func))
                return out

        self.mode = _Mode()


def serving_phase(model, rng, gpu: str, kernel: str = 'ragged_fwd',
                  buckets=BUCKETS) -> int:
    """The main path: predict at each bucket on three tiers; every call
    must launch ``kernel`` once and no other kernel. Returns ``kernel``'s
    launches in this run."""
    import torch
    config = model.config
    route = '%s wire, %s' % (config.BATCH_WIRE_FORMAT, kernel)
    sizes = (model.vocabs.token_vocab.size - 1,
             model.vocabs.path_vocab.size - 1,
             model.vocabs.target_vocab.size - 1)
    k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    zero_counts()
    calls = 0

    def predict(lines, tier):
        nonlocal calls
        before = launch_counts()
        results = model.predict(lines, tier=tier)
        after = launch_counts()
        calls += 1
        launched = {name: after[name] - before[name] for name in after}
        check(launched == {name: int(name == kernel) for name in after},
              'predict(%s, %d lines) on the %s route launched %s'
              % (tier, len(lines), route, launched))
        return results

    for bucket, n_lines in buckets:
        lines = make_lines(rng, n_lines, sizes, config.MAX_CONTEXTS)
        for tier in TIERS:
            for rep in range(2):
                t0 = time.perf_counter()
                results = predict(lines, tier)
                latency = (time.perf_counter() - t0) * 1e3
                check(len(results) == n_lines, 'wrong result count')
                for r in results:
                    if tier == 'vectors':
                        check(r.code_vector.shape == (config.CODE_VECTOR_SIZE,)
                              and np.isfinite(r.code_vector).all(),
                              'bad code vector')
                        continue
                    check(len(r.topk_predicted_words) == k
                          and r.topk_predicted_words_scores.shape == (k,)
                          and np.isfinite(r.topk_predicted_words_scores).all(),
                          'bad top-k')
                    check(abs(float(r.topk_predicted_words_scores.sum())
                              - 1.0) < 1e-3, 'top-k scores do not sum to 1')
                    if tier == 'attention':
                        values = list(r.attention_per_context.values())
                        check(values and np.isfinite(values).all(),
                              'bad attention')
                if rep == 1:
                    print('serving (%s) predict tier=%s bucket=%d lines=%d: '
                          '%.3f ms [%s]' % (route, tier, bucket, n_lines,
                                            latency, gpu))
        if bucket == 64:
            watch = CpuOpWatch()
            with torch.no_grad(), watch.mode:
                for tier in TIERS:
                    predict(lines, tier)
            check(not watch.cpu_ops,
                  'CPU operations on the serving path (%s): %s'
                  % (route, sorted(set(watch.cpu_ops))))
    launches = launch_counts()[kernel]
    check(launches == calls, '%s launched %d times in %d predict calls'
          % (kernel, launches, calls))
    print('serving (%s): %d predict calls, %d %s launches (1 per predict, '
          'every bucket; no other kernel; no CPU op at bucket 64) [%s]'
          % (route, calls, launches, kernel, gpu))
    return launches


def breakdown_phase(model, rng, gpu: str) -> None:
    """Where a bucket-1024 predict call spends its time: host tokenize,
    host pack (packed wire), device predict step per tier (graph replay),
    host decode."""
    import torch
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.serving import engine as engine_lib
    from code2vec_tpu_torch.serving.steps import predict_step
    wire_format = model.config.BATCH_WIRE_FORMAT
    sizes = (model.vocabs.token_vocab.size - 1,
             model.vocabs.path_vocab.size - 1,
             model.vocabs.target_vocab.size - 1)
    lines = make_lines(rng, 1000, sizes, model.config.MAX_CONTEXTS)
    t0 = time.perf_counter()
    batch = model.reader.pad_batch_to(model.reader.process_input_rows(lines),
                                      1024)
    t1 = time.perf_counter()
    wire = batch
    if wire_format == 'packed':
        wire = packed_lib.pack_batch(batch, model.backend.token_pad_index,
                                     model.backend.path_pad_index)
    t2 = time.perf_counter()
    arrays = tuple(torch.from_numpy(a).cuda() for a in wire.device_arrays())
    device_ms = {tier: cuda_ms(lambda tier=tier: predict_step(
        model.backend, arrays, tier=tier)) for tier in TIERS}
    out = predict_step(model.backend, arrays, tier='attention')
    fetched = {key: value.cpu().numpy() for key, value in out.items()}
    t3 = time.perf_counter()
    engine_lib.decode_results(fetched, batch, len(lines),
                              model._target_index_to_word)
    t4 = time.perf_counter()
    print('breakdown (%s wire) bucket=1024 lines=1000 valid contexts=%d: '
          'host tokenize+pad %.1f ms, host pack %.1f ms, device predict '
          'step %s, host decode (attention) %.1f ms [%s]'
          % (wire_format, int(batch.mask.sum()), (t1 - t0) * 1e3,
             (t2 - t1) * 1e3,
             ', '.join('%s %.4f ms' % kv for kv in device_ms.items()),
             (t4 - t3) * 1e3, gpu))


def topk_reference(x: np.ndarray, k: int) -> np.ndarray:
    """lax.top_k's indices in plain numpy: IEEE total order (+0.0 above
    -0.0; the fp32 bits as an int, the magnitude bits flipped when
    negative), descending, the lower index first among equal values (a
    stable sort)."""
    bits = x.astype(np.float32).view(np.int32).astype(np.int64)
    key = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return np.argsort(-key, axis=-1, kind='stable')[..., :k]


def topk_phase(model, rng, gpu: str) -> None:
    """``ops/topk.py::top_k`` on the card against topk_reference (the
    card has no JAX): bf16-rounded logits at the java14m target width
    (ties in the top ten of most rows), k above the valid vocabulary over
    -1e9 padding, and +-0.0. Then what it costs: the predict step's device
    time (topk tier, graph replay) at buckets 8, 64 and 1024 with top_k
    and with torch.topk (no tie order) in its place, in the order
    torch.topk, top_k, top_k, torch.topk, and the two alone on the step's
    logits."""
    import torch
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.ops.topk import top_k
    from code2vec_tpu_torch.serving import steps
    width = model.backend.compute_params.target_embedding.shape[0]
    k = model.config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    padded = np.full((32, 1000), -1e9, np.float32)
    padded[:, :40] = rng.normal(0.0, 1.0, (32, 40))
    cases = {
        'java14m width': (rng.normal(0.0, 1.0, (64, width)), k),
        'k above the valid vocabulary': (padded, 64),
        'signed zeros': (rng.choice(np.array([0.0, -0.0, 1.0, -1.0],
                                             np.float32), (16, 300)), 100),
    }
    tie_rows = {}
    for name, (x, kk) in cases.items():
        x = torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
        values, indices = top_k(torch.from_numpy(x).cuda(), kk)
        got = indices.cpu().numpy()
        want = topk_reference(x, kk)
        check(np.array_equal(got, want), 'top_k on the card (%s) breaks ties '
              'otherwise than lax.top_k: %d rows differ'
              % (name, int((got != want).any(axis=-1).sum())))
        check(np.array_equal(values.cpu().numpy().view(np.int32),
                             np.take_along_axis(x, want, -1).view(np.int32)),
              'top_k on the card (%s): values are not the logits' % name)
        plain = torch.topk(torch.from_numpy(x).cuda(), kk).indices
        tie_rows[name] = int((plain.cpu().numpy() != want).any(-1).sum())
    print('top_k on the card: lax.top_k order on %s (rows where torch.topk '
          'alone orders otherwise: %s) [%s]'
          % (sorted(cases), tie_rows, gpu))

    sizes = (model.vocabs.token_vocab.size - 1,
             model.vocabs.path_vocab.size - 1,
             model.vocabs.target_vocab.size - 1)
    plain_top_k = lambda logits, kk: torch.topk(
        logits, min(kk, logits.shape[-1]), dim=-1, sorted=True)
    for bucket, n_lines in BUCKETS:
        lines = make_lines(rng, n_lines, sizes, model.config.MAX_CONTEXTS)
        batch = model.reader.pad_batch_to(
            model.reader.process_input_rows(lines), bucket)
        wire = packed_lib.pack_batch(batch, model.backend.token_pad_index,
                                     model.backend.path_pad_index)
        arrays = tuple(torch.from_numpy(a).cuda()
                       for a in wire.device_arrays())
        run = lambda: steps.predict_step(model.backend, arrays, tier='topk')
        readings = []
        for use in (plain_top_k, top_k, top_k, plain_top_k):
            steps.top_k = use
            try:
                readings.append(cuda_ms(run))
            finally:
                steps.top_k = top_k
        code = model.backend.encode_arrays(arrays)[0]
        logits = model.backend.logits(code)
        alone = (cuda_ms(lambda: plain_top_k(logits, k)),
                 cuda_ms(lambda: top_k(logits, k)))
        print('top_k cost, bucket %d (logits %d x %d): predict step (topk '
              'tier) with torch.topk %.4f/%.4f ms, with top_k %.4f/%.4f ms '
              '(device, graph replay, order torch.topk, top_k, top_k, '
              'torch.topk); alone torch.topk %.4f ms, top_k %.4f ms [%s]'
              % (bucket, logits.shape[0], logits.shape[1], readings[0],
                 readings[3], readings[1], readings[2], alone[0], alone[1],
                 gpu))
        del logits, code


EVAL_LINES = 4096


def evaluate_phase(model, gpu: str, kernel: str) -> int:
    """``Code2VecModel.evaluate()`` over the synthetic test split at
    java14m width, in the working directory build/smoke/ (its log.txt
    lands there): every batch launches ``kernel`` once and no other
    kernel. Then where one batch's time goes. Returns the launches."""
    import contextlib
    import torch
    from code2vec_tpu_torch.data.reader import PathContextReader
    from code2vec_tpu_torch.metrics import (SubtokensEvaluationMetric,
                                            TopKAccuracyEvaluationMetric,
                                            decode_topk_batch)
    config = model.config
    route = '%s wire, %s' % (config.BATCH_WIRE_FORMAT, kernel)
    k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    batches = -(-EVAL_LINES // config.TEST_BATCH_SIZE)
    if config.READER_USE_NATIVE:
        # once per vocabulary object, before the timed call
        t0 = time.perf_counter()
        PathContextReader(model.vocabs, config).native_tokenizer()
        print('evaluate (%s): native tokenizer loaded and its vocabulary '
              'uploaded in %.2f s, before the call [%s]'
              % (route, time.perf_counter() - t0, gpu))
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(SMOKE_DIR):
        results = model.evaluate()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check(counts == {name: batches * int(name == kernel) for name in counts},
          'evaluate() on the %s route in %d batches launched %s'
          % (route, batches, counts))
    check(results.topk_acc.shape == (k,)
          and bool(np.all(np.diff(results.topk_acc) >= 0))
          and 0 <= results.topk_acc[-1] <= 1
          and all(0 <= v <= 1 for v in (results.subtoken_precision,
                                        results.subtoken_recall,
                                        results.subtoken_f1))
          and results.loss is not None and math.isfinite(results.loss),
          'bad evaluation results: %s' % (results,))
    log_lines = (SMOKE_DIR / 'log.txt').read_text().count('\n')
    check(log_lines == EVAL_LINES, 'log.txt holds %d lines for %d examples'
          % (log_lines, EVAL_LINES))
    print('evaluate (%s): %d lines, %d batches of %d: top-1 acc %.6f, '
          'top-%d acc %.6f, precision %.6f, recall %.6f, F1 %.6f, loss %.6f, '
          '%.2f s (%.0f examples/s, host clock); launches %s [%s]'
          % (route, EVAL_LINES, batches, config.TEST_BATCH_SIZE,
             results.topk_acc[0], k, results.topk_acc[-1],
             results.subtoken_precision, results.subtoken_recall,
             results.subtoken_f1, results.loss, seconds,
             EVAL_LINES / seconds, counts, gpu))

    # one batch cut at its phase boundaries
    reader = PathContextReader(model.vocabs, config)
    t0 = time.perf_counter()
    host_batches = list(reader.iter_epoch(evaluate=True))
    read_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
    batch = host_batches[0]
    arrays = tuple(torch.from_numpy(a).cuda() for a in batch.device_arrays())
    step_ms = cuda_ms(lambda: model.trainer.eval_step(arrays))
    out = model.trainer.eval_step(arrays)
    t0 = time.perf_counter()
    fetched = {key: value.cpu().numpy() for key, value in out.items()}
    decoded = decode_topk_batch(fetched['topk_indices'],
                                model._target_index_to_word,
                                batch.label_strings, batch.weight)
    oov = model.vocabs.target_vocab.special_words.OOV
    TopKAccuracyEvaluationMetric(k, oov).update_batch(decoded)
    SubtokensEvaluationMetric(oov).update_batch(decoded)
    with open(SMOKE_DIR / 'log_breakdown.txt', 'w') as f:
        model._log_predictions_during_evaluation(decoded, f)
    decode_ms = (time.perf_counter() - t0) * 1e3
    print('evaluate breakdown (%s), per batch of %d: host read+tokenize+'
          'filter%s %.1f ms, device eval step %.4f ms (graph replay), host '
          'fetch+decode+metrics+log %.1f ms [%s]'
          % (route, config.TEST_BATCH_SIZE,
             '+pack' if config.BATCH_WIRE_FORMAT == 'packed' else '',
             read_ms, step_ms, decode_ms, gpu))
    return counts[kernel]


def evaluate_reference_phase(rng) -> int:
    """A small-vocabulary model at full width evaluates the same test
    split on the card (plane wire, encode kernel) and on the CPU (plain
    versions) from the same weights, fp32: equal metrics and log. Returns
    the card's encode launches (the fp32 kernel's main path)."""
    import contextlib
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = SMOKE_DIR / 'small'
    test_path = SMOKE_DIR / 'small.test.c2v'
    lines = make_lines(rng, 300, (299, 199, 49), 200)
    test_path.write_text('\n'.join(lines) + '\n')
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    TEST_DATA_PATH=str(test_path), TEST_BATCH_SIZE=128,
                    COMPUTE_DTYPE='float32', BATCH_WIRE_FORMAT='planes',
                    USE_PALLAS_FUSED_ENCODE=True)
    cpu = Code2VecModel(config, device='cpu', seed=4)
    card = Code2VecModel(config, device='cuda',
                         params=convert.params_from_numpy(
                             convert.params_to_numpy(cpu.backend.params),
                             'cuda'))
    logs = []
    with contextlib.chdir(SMOKE_DIR):
        want = cpu.evaluate()
        logs.append((SMOKE_DIR / 'log.txt').read_text())
        zero_counts()
        got = card.evaluate()
        launched = launch_counts()
        logs.append((SMOKE_DIR / 'log.txt').read_text())
    check(launched['encode'] == 3 and launched['ragged_fwd'] == 0,
          'card evaluate() launched %s in 3 batches' % launched)
    check(bool(np.array_equal(got.topk_acc, want.topk_acc))
          and (got.subtoken_precision, got.subtoken_recall, got.subtoken_f1)
          == (want.subtoken_precision, want.subtoken_recall,
              want.subtoken_f1), 'evaluate() on the card %s vs the CPU %s'
          % (got, want))
    check(logs[0] == logs[1], 'log.txt differs between the card and the CPU')
    loss_err = abs(got.loss - want.loss) / abs(want.loss)
    # fp32 on both sides: the card's kernel and cuBLAS sum in another
    # order than the CPU, ~1e-7 of the loss
    check(loss_err <= 1e-5, 'evaluate() loss on the card %.8f vs the CPU '
          '%.8f' % (got.loss, want.loss))
    check(want.topk_acc[-1] > 0 and want.subtoken_f1 > 0,
          'the reference evaluation scored nothing: %s' % (want,))
    print('evaluate reference: 300 lines, a 300/200/50-word model at full '
          'width, fp32, plane wire + encode kernel on the card vs the CPU '
          'plain path: top-k acc %s, precision %.6f, recall %.6f, F1 %.6f '
          'equal, log.txt equal; loss %.8f vs %.8f (rel err %.3g, limit '
          '1e-5)' % (np.array2string(got.topk_acc, precision=4),
                     got.subtoken_precision, got.subtoken_recall,
                     got.subtoken_f1, got.loss, want.loss, loss_err))
    return launched['encode']


def train_batch(rng, batch: int, max_contexts: int, vocab_sizes,
                token_pad: int, path_pad: int):
    """One packed training batch: kernel_batch's slots, labels over the
    real targets, weight 0 on the empty rows."""
    n_tok, n_path, n_tgt = vocab_sizes
    packed = kernel_batch(rng, batch, max_contexts, n_tok, n_path, token_pad,
                          path_pad)
    return packed._replace(
        label=rng.integers(1, n_tgt, batch).astype(np.int32),
        weight=(packed.count > 0).astype(np.float32))


def device_arrays(packed):
    import torch
    return tuple(torch.from_numpy(a).cuda() for a in (
        packed.ctx, packed.count, packed.label, packed.weight))


def scaled_err(got, want) -> float:
    """max |got - want| over the largest |want|, each tensor on its own
    scale; the largest across tensors."""
    return worst(*(float((g.float() - w.float()).abs().max())
                     / max(float(w.float().abs().max()), 1e-30)
                     for g, w in zip(got, want)))


def per_example_err(got_de, want_de, segs) -> float:
    """The ragged backward's ``de`` with each valid slot held on the scale
    of its own example (the largest |want| among the example's slots):
    ``de`` carries the attention weight p/z, so an example of 200 contexts
    sits ~200x below one of a single context, and one scale for the whole
    tensor would hide an error in the long examples."""
    import torch
    valid = segs.slot_valid
    row_max = torch.where(valid, want_de.abs().amax(-1), 0.0)
    ex_max = torch.zeros(segs.count2.shape, dtype=row_max.dtype,
                         device=row_max.device
                         ).scatter_reduce(1, segs.seg, row_max, 'amax')
    scale = torch.gather(ex_max, 1, segs.seg).clamp_min(1e-30)
    err = (got_de - want_de).abs().amax(-1) / scale
    return float(torch.where(valid, err, 0.0).max())


# Limit on the ragged backward's de (per example) and dW against a float64
# reference fed the kernel's own du (own_du_reference): both sides take
# the same rounded du, so only the fp32 sums' order and rounding remain,
# where a flipped bf16 ulp of du reads ~1e-3 against the plain version.
# On an H100 (PERF.md) the largest readings were 1.7e-6 here (dW, bf16,
# training batch) and 9.0e-7 in scripts/torch_kernel_checks.py
# rounding-noise (six draws of weights, K, D in {128, 256, 384}); the
# limit sits ~12x above them and 50x below the 1e-3 check.
OWN_DU_LIMIT = 2e-5


def own_du_reference(args, segs, keep, rate, du):
    """de = du W^T (times the keep mask / keep rate) and dW = e^T du in
    float64 from the kernel's own du stream and the rows rounded (and
    masked) as the kernel rounds them."""
    from code2vec_tpu_torch.ops import ragged
    tok, path, w, _attn = args
    e = ragged._gather(tok, path, segs, w.dtype, keep, rate).double()
    du = du.double()
    de = du @ w.double().T
    if keep is not None:
        de = ragged.apply_keep(de, keep, rate)
    return de, (e.reshape(-1, e.shape[-1]).T
                @ du.reshape(-1, du.shape[-1]))


def ragged_bwd_parts(args, segs, m, z, gc, g2, keep, rate, tpad: int,
                     ppad: int):
    """The ragged backward kernel against its plain version, each part on
    its own scale (``de`` also per example), and its de and dW against
    own_du_reference. Returns (scaled errors by part, max |diff|, the
    kernel's and the plain version's calls)."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    bwd_args = args + (segs, m, z, gc, g2, keep, rate)
    run_kernel = lambda: ragged._grads_kernel(
        *bwd_args, token_pad=tpad, path_pad=ppad)
    run_plain = lambda: ragged._grads_plain(*bwd_args)
    *got, du = ragged._grads_kernel_du(*bwd_args, token_pad=tpad,
                                       path_pad=ppad)
    want = run_plain()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in got),
          'non-finite ragged_bwd output')
    parts = {'de (per example)': per_example_err(got[0], want[0], segs),
             'de': scaled_err(got[:1], want[:1]),
             'dW': scaled_err(got[1:2], want[1:2]),
             'd_attn': scaled_err(got[2:], want[2:])}
    own = own_du_reference(args, segs, keep, rate, du)
    own_parts = {'de vs own du (per example)': per_example_err(
                     got[0], own[0].float(), segs),
                 'dW vs own du': scaled_err(got[1:2], own[1:])}
    check(worst(*own_parts.values()) <= OWN_DU_LIMIT,
          'ragged_bwd against the float64 reference fed its own du: %s, '
          'limit %.3g' % (own_parts, OWN_DU_LIMIT))
    parts.update(own_parts)
    return parts, max_err(got, want), run_kernel, run_plain


def ragged_bwd_float64(args, segs, m, z, gc, g2, keep, rate):
    """The fp32 recompute backward in float64 (``_grads_plain``'s steps,
    du not rounded): (de with the keep mask applied, dW, d_attn)."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    tok, path, w, attn = args
    e = ragged._gather(tok, path, segs, torch.float32, keep, rate).double()
    w64, a64 = w.double(), attn.double().reshape(-1)
    x = torch.tanh(e @ w64)
    m_s = torch.gather(m.double(), 1, segs.seg)
    z_s = torch.gather(z.double(), 1, segs.seg)
    p = torch.where(segs.slot_valid, torch.exp(x @ a64 - m_s), 0.0)
    wt = p / torch.where(z_s > 0, z_s, 1.0)
    g_s = torch.gather(g2.double(), 1, segs.seg[..., None].expand(
        -1, -1, g2.shape[-1]))
    ds = wt * ((x * g_s).sum(-1) - torch.gather(gc.double(), 1, segs.seg))
    du = (1 - x * x) * (wt[..., None] * g_s + ds[..., None] * a64)
    de = du @ w64.T
    if keep is not None:
        de = ragged.apply_keep(de, keep, rate)
    return (de, e.reshape(-1, e.shape[-1]).T @ du.reshape(-1, du.shape[-1]),
            torch.einsum('sc,scd->d', ds, x))


def ragged_bwd_float64_checks(args, segs, m, z, gc, g2, keep, rate,
                              tpad: int, ppad: int) -> dict:
    """The fp32 ragged backward kernel (three TF32 terms) and its plain
    version (fp32 cuBLAS, TF32 off) against ragged_bwd_float64: each
    output's error (de also per example, as ragged_bwd_parts reads it) of
    the kernel may be at most F64_FACTOR times the plain version's.
    Returns {output: (kernel error, plain error)}."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    want = ragged_bwd_float64(args, segs, m, z, gc, g2, keep, rate)
    bwd_args = args + (segs, m, z, gc, g2, keep, rate)
    readings = {}
    for tag, got in (('kernel', ragged._grads_kernel(
                         *bwd_args, token_pad=tpad, path_pad=ppad)),
                     ('plain', ragged._grads_plain(*bwd_args))):
        torch.cuda.synchronize()
        readings.setdefault('de (per example)', {})[tag] = per_example_err(
            got[0].double(), want[0], segs)
        for name, g, v in zip(('de', 'dW', 'd_attn'), got, want):
            readings.setdefault(name, {})[tag] = float(
                (g.double() - v).abs().max() / v.abs().max())
        del got
    for name, r in readings.items():
        check(r['kernel'] <= F64_FACTOR * r['plain'],
              'ragged_bwd fp32 %s against float64: kernel %.3g, more than '
              '%.0fx the plain version\'s %.3g'
              % (name, r['kernel'], F64_FACTOR, r['plain']))
    return {name: (r['kernel'], r['plain']) for name, r in readings.items()}


# counts that put examples on the edges of the backward's 64-slot tiles:
# slots 0 (one slot), 1-63 (63), 64-127 (exactly one tile), 128-192 (one
# slot past a tile), two empty examples, one slot, then random counts
EDGE_COUNTS = (1, 63, 64, 65, 0, 0, 1)


def edge_segments(rng, token_rows: int, path_rows: int, tpad: int,
                  ppad: int, shards: int = 1, tail: int = 37,
                  head=EDGE_COUNTS, dead_tile: bool = False):
    """A packed stream at the edges of the slot tiles: ``head`` counts
    then random counts (200 examples per shard), interior all-PAD holes,
    and (one shard) a capacity of 64 k + ``tail`` slots, so the last tile
    is partial; with ``dead_tile``, every slot of the third tile (slots
    128-191, inside examples) all-PAD. Returns the device segment
    inputs."""
    import torch
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.ops import ragged
    batch = 200 * shards
    counts = context_counts(rng, batch, 200)
    counts[:len(head)] = head
    packed = packed_lib.pack_batch(
        plane_batch(rng, batch, 200, token_rows, path_rows, tpad, ppad,
                    counts=counts), tpad, ppad, data_shards=shards)
    ctx = packed.ctx
    if dead_tile:
        ctx[0, 128:192] = (tpad, ppad, tpad)
    if shards == 1:
        total = int(packed.count.sum())
        cap = -(-(total + 1) // 64) * 64 + tail
        trimmed = np.empty((1, cap, 3), np.int32)
        trimmed[..., 0] = tpad
        trimmed[..., 1] = ppad
        trimmed[..., 2] = tpad
        keep_n = min(cap, ctx.shape[1])
        trimmed[:, :keep_n] = ctx[:, :keep_n]
        ctx = trimmed
    segs = ragged._segment_inputs(torch.from_numpy(ctx).cuda(),
                                  torch.from_numpy(packed.count).cuda(),
                                  tpad, ppad)
    holes = ~segs.slot_valid & (segs.pos < torch.gather(
        segs.count2, 1, segs.seg).to(segs.pos.dtype))
    check(bool(holes.any()), 'the edge stream has no interior hole')
    return segs


def small_encoder(gen, dt: int, dp: int, d_code: int):
    """fp32 tables (2,000 and 1,000 rows), W (2 dt + dp, d_code) and the
    attention vector (d_code,) drawn as the model initialises them
    (models/functional.py::init_params): tables U(+-sqrt(3 / dim)), W and
    attention glorot-uniform."""
    import torch
    k_dim = 2 * dt + dp

    def uniform(shape, limit):
        return torch.from_numpy(gen.uniform(-limit, limit, shape).astype(
            np.float32)).cuda()
    return (uniform((2000, dt), math.sqrt(3.0 / dt)),
            uniform((1000, dp), math.sqrt(3.0 / dp)),
            uniform((k_dim, d_code), math.sqrt(6.0 / (k_dim + d_code))),
            uniform((d_code,), math.sqrt(6.0 / (d_code + 1))))


# the forward's edge counts: EDGE_COUNTS (examples of 1, 63, 64 and 65
# slots; the 64- and 65-slot ones start exactly at tile edges 64 and 128;
# two empty examples) and one of 200 slots across four tiles
FWD_EDGE_COUNTS = EDGE_COUNTS + (200,)


def ragged_fwd_check(args, segs, keep, rate: float, tpad: int, ppad: int,
                     tag: str, e=None) -> float:
    """The forward kernel against its plain version on one stream: scores,
    m, z and acc within rtol 1e-4, atol 1e-5 (the limits of the serving
    and training checks); with ``e`` the kernel reads that stream (a
    mesh's, the keep mask applied in it). Returns max |diff|."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    plan, plan_plain = ragged._pair_map_kernel(segs), ragged._pair_map(segs)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(g, w)) for g, w in zip(plan[:3],
                                                      plan_plain[:3])),
          'ragged_fwd %s: the plan kernel\'s pair map differs from '
          '_pair_map' % tag)
    got = ragged._stats_kernel(*args, segs, tpad, ppad, keep, rate, e=e)
    want = ragged._stats_plain(*args, segs, tpad, ppad, keep, rate)
    torch.cuda.synchronize()
    for name, g, w in zip(('scores', 'm', 'z', 'acc'), got, want):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              'ragged_fwd %s %s: shape %s or non-finite'
              % (tag, name, tuple(g.shape)))
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                   msg=lambda m, n=name: 'ragged_fwd %s %s: '
                                   '%s' % (tag, n, m))
    return max_err(got, want)


def ragged_fwd_edge_cases(params, dtype: str, tpad: int, ppad: int) -> dict:
    """The forward kernel at the edges of its 64-slot tiles, ``dtype``
    compute: examples of 0, 1, 63, 64, 65 and 200 slots, examples starting
    exactly at a tile edge, a partial last tile, interior holes, a tile
    whose every slot is invalid and a tile past the stream's total, fp32
    masters with the keep mask (training) and without, bf16 tables with
    and without it (bf16 only), two shards with slots past a shard's
    total, and K, D in {128, 256} on small tables. Returns max |diff| by
    case."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    tdtype = getattr(torch, dtype)
    gen = np.random.default_rng(31)
    rate = 0.75
    w_c = params.transform.to(tdtype)
    a_c = params.attention.to(tdtype).reshape(-1)
    masters = (params.token_embedding, params.path_embedding)
    tables = {'fp32 tables': masters}
    if dtype == 'bfloat16':
        tables['bf16 tables'] = tuple(t.to(tdtype) for t in masters)
    rows = (masters[0].shape[0], masters[1].shape[0])
    segs = edge_segments(gen, *rows, tpad, ppad, head=FWD_EDGE_COUNTS,
                         dead_tile=True)
    check(not bool(segs.slot_valid[0, 128:192].any()),
          'the forward edge stream has no all-invalid tile')
    segs2 = edge_segments(gen, *rows, tpad, ppad, shards=2,
                          head=FWD_EDGE_COUNTS)
    keep = ragged._draw_keep(37, segs, w_c.shape[0], rate)
    keep2 = ragged._draw_keep(41, segs2, w_c.shape[0], rate)
    errs = {}
    for name, (tok, path) in tables.items():
        args = (tok, path, w_c, a_c)
        for tag, sg, kp in (('edges', segs, None), ('edges, keep', segs, keep),
                            ('2 shards', segs2, None),
                            ('2 shards, keep', segs2, keep2)):
            label = '%s %s' % (name, tag)
            errs[label] = ragged_fwd_check(args, sg, kp, rate, tpad, ppad,
                                           '%s %s' % (dtype, label))
    for k_dim, d_code in ((128, 128), (256, 256), (128, 256), (256, 128)):
        dt, dp = (32, 64) if k_dim == 128 else (64, 128)
        tok, path, w, attn = small_encoder(gen, dt, dp, d_code)
        segs_s = edge_segments(gen, 2000, 1000, tpad, ppad, tail=5,
                               head=FWD_EDGE_COUNTS, dead_tile=True)
        keep_s = ragged._draw_keep(43, segs_s, k_dim, rate)
        label = 'K=%d D=%d' % (k_dim, d_code)
        errs[label] = ragged_fwd_check(
            (tok, path, w.to(tdtype), attn.to(tdtype)), segs_s, keep_s,
            rate, tpad, ppad, '%s %s' % (dtype, label))
    return errs


# the fp32 forward's edge counts: FWD_EDGE_COUNTS and one of 130 slots
# from slot 394, across three tiles
FWD_FP32_EDGE_COUNTS = FWD_EDGE_COUNTS + (130,)
# the fp32 forward's other shapes (dt, dp, D): K = 96 and D = 192; W's
# rows padded to a multiple of 4 (D = 102); x in two passes (D = 1024)
FWD_FP32_SHAPES = ((32, 32, 192), (12, 8, 102), (32, 32, 1024))


def ragged_fwd_fp32_edge_cases(args, tpad: int, ppad: int) -> dict:
    """The fp32 forward (three TF32 terms) at the edges of its 64-slot
    tiles against its plain version, on the tables, W and attention of
    ``args``: examples of 1, 63, 64 and 65 slots, two empty ones, one
    across four tiles and one across three, a tile whose every slot is
    invalid (an all-PAD hole), a partial last tile, the keep mask off and
    on, the given e stream (a mesh's), and FWD_FP32_SHAPES on small
    tables. Returns max |diff| by case."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    gen = np.random.default_rng(47)
    rate = 0.75
    rows = (args[0].shape[0], args[1].shape[0])
    segs = edge_segments(gen, *rows, tpad, ppad, head=FWD_FP32_EDGE_COUNTS,
                         dead_tile=True)
    keep = ragged._draw_keep(53, segs, args[2].shape[0], rate)
    errs = {}
    for tag, kp in (('mask off', None), ('mask on', keep)):
        errs[tag] = ragged_fwd_check(args, segs, kp, rate, tpad, ppad,
                                     'float32 ' + tag)
    e = ragged._gather(*args[:2], segs, torch.float32, keep, rate)
    errs['given e stream'] = ragged_fwd_check(
        args, segs, keep, rate, tpad, ppad, 'float32 given e stream', e=e)
    for dt, dp, d_code in FWD_FP32_SHAPES:
        small = small_encoder(gen, dt, dp, d_code)
        segs_s = edge_segments(gen, 2000, 1000, tpad, ppad, tail=5,
                               head=FWD_FP32_EDGE_COUNTS, dead_tile=True)
        keep_s = ragged._draw_keep(59, segs_s, 2 * dt + dp, rate)
        label = 'dt=%d dp=%d D=%d' % (dt, dp, d_code)
        errs[label] = ragged_fwd_check(small, segs_s, keep_s, rate, tpad,
                                       ppad, 'float32 ' + label)
    return errs


def ragged_fwd_float64(args, segs, keep, rate):
    """The forward's statistics in float64 from the fp32 rows the kernel
    gathers (the keep mask applied): (scores, m, z, acc) shaped as
    ``_stats_plain``'s."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    tok, path, w, attn = args
    e = ragged._gather(tok, path, segs, torch.float32, keep, rate).double()
    x = torch.tanh(e @ w.double())
    d_code = x.shape[-1]
    valid = segs.slot_valid
    scores = torch.where(valid, x @ attn.double().reshape(-1), -1e30)
    shards, per_shard = segs.count2.shape
    base = (torch.arange(shards, device=x.device) * per_shard)[:, None]
    flat = (segs.seg + base).reshape(-1)
    f64 = dict(dtype=torch.float64, device=x.device)
    m = torch.full((shards * per_shard,), -1e30, **f64).scatter_reduce(
        0, flat, scores.reshape(-1), reduce='amax')
    p = torch.where(valid.reshape(-1),
                    torch.exp(scores.reshape(-1) - m[flat]), 0.0)
    z = torch.zeros((shards * per_shard,), **f64).index_add(0, flat, p)
    acc = torch.zeros((shards * per_shard, d_code), **f64).index_add(
        0, flat, p[:, None] * x.reshape(-1, d_code))
    return (scores, m.reshape(shards, per_shard), z.reshape(shards, per_shard),
            acc.reshape(shards, per_shard, d_code))


def ragged_fwd_float64_checks(args, segs, keep, rate, tpad: int,
                              ppad: int) -> dict:
    """The fp32 forward kernel (three TF32 terms) and its plain version
    (fp32 cuBLAS, TF32 off) against ragged_fwd_float64, over the entries
    that carry a value (valid slots' scores; non-empty examples' m, z and
    acc): each output's error (max |diff| over max |float64|) of the kernel
    may be at most F64_FACTOR times the plain version's. Returns {output:
    (kernel error, plain error)}."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    want = ragged_fwd_float64(args, segs, keep, rate)
    readings = {}
    for tag, got in (('kernel', ragged._stats_kernel(*args, segs, tpad, ppad,
                                                     keep, rate)),
                     ('plain', ragged._stats_plain(*args, segs, tpad, ppad,
                                                   keep, rate))):
        torch.cuda.synchronize()
        for name, g, v in zip(('scores', 'm', 'z', 'acc'), got, want):
            sel = segs.slot_valid if name == 'scores' else segs.count2 > 0
            g, v = g[sel].double(), v[sel]
            readings.setdefault(name, {})[tag] = float(
                (g - v).abs().max() / v.abs().max())
        del got
    for name, r in readings.items():
        check(r['kernel'] <= F64_FACTOR * r['plain'],
              'ragged_fwd fp32 %s against float64: kernel %.3g, more than '
              '%.0fx the plain version\'s %.3g'
              % (name, r['kernel'], F64_FACTOR, r['plain']))
    return {name: (r['kernel'], r['plain']) for name, r in readings.items()}


def ragged_fwd_fp32_record(args, segs, keep, rate: float, tpad: int,
                           ppad: int, retained: int, gpu: str) -> dict:
    """The fp32 forward (three TF32 terms) at the training shape: against
    its plain version (the caller held them within rtol 1e-4, atol 1e-5)
    and float64, the same bits on two launches, its edge cases; its time
    twice beside the plain version's and the three-term TF32 bound (the
    CUDA cores' beside it). Returns the record."""
    from code2vec_tpu_torch.ops import ragged
    run_kernel = lambda: ragged._stats_kernel(*args, segs, tpad, ppad, keep,
                                              rate)
    run_plain = lambda: ragged._stats_plain(*args, segs, tpad, ppad, keep,
                                            rate)
    err = max_err(run_kernel(), run_plain())
    check(same_bits(run_kernel), 'ragged_fwd float32: two launches differ')
    f64 = ragged_fwd_float64_checks(args, segs, keep, rate, tpad, ppad)
    edges = ragged_fwd_fp32_edge_cases(args, tpad, ppad)
    ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
    ms2 = cuda_ms(run_kernel)
    k_dim, d_code = args[2].shape
    batch = segs.count2.numel()
    bytes_moved = (retained * (k_dim * 4 + k_dim + 12)  # fp32 rows, the
                   # mask, triples; W, attention; scores, m, z, acc
                   + (k_dim + 1) * d_code * 4 + segs.ctx.shape[1] * 4
                   + batch * (2 + d_code) * 4)
    flops = retained * (2 * k_dim * d_code + 4 * d_code)
    b_ms, b_by = bound(bytes_moved, flops, 'tf32x3')
    print('kernel ragged_fwd float32 (three-term TF32, 64-slot tiles), '
          'training shape (fp32 masters, keep %.2f): B=%d slots=%d '
          'max_abs_err=%.3g; the same bits on two launches; against float64 '
          '(kernel, plain: max |diff| over max |float64|, the kernel within '
          '%.0fx) %s; edge cases (rtol 1e-4, atol 1e-5) %s; kernel '
          '%.4f/%.4f ms, plain %.4f ms (device, graph replay), bound %.4f ms '
          '(%s, three-term TF32 at %.0f TFLOP/s; on the CUDA cores %.4f ms) '
          '[%s]'
          % (rate, batch, retained, err, F64_FACTOR,
             {k: (float('%.3g' % a), float('%.3g' % b))
              for k, (a, b) in f64.items()},
             {k: float('%.3g' % v) for k, v in edges.items()}, ms, ms2,
             plain_ms, b_ms, b_by, PEAK_FLOPS['tf32x3'] / 1e12,
             bound(bytes_moved, flops, 'float32')[0], gpu))
    return record('ragged_fwd_fp32',
                  'code2vec_tpu_torch/ops/csrc/ragged_fwd.cu',
                  'code2vec_tpu/ops/pallas_ragged.py:150', err, ms, plain_ms,
                  b_ms, b_by, None)


def ragged_bwd_edge_cases(params, dtype: str, rate: float, tpad: int,
                          ppad: int) -> dict:
    """The ragged backward at the edges of its slot tiles, each part as in
    ragged_bwd_parts: examples of 0, 1, 63, 64 (one whole tile) and 65
    slots, a partial last tile and interior holes, at the training widths
    (fp32 tables with the keep mask; bf16 tables without one, on a stream
    of two shards); and the other widths K, D in {128, 256} on small
    tables."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    tdtype = getattr(torch, dtype)
    gen = np.random.default_rng(17)
    parts = {}

    def run(tag, tok, path, w, attn, segs, keep, keep_rate):
        args = (tok, path, w, attn)
        _s, m, z, acc = ragged._stats_plain(*args, segs, tpad, ppad, keep,
                                            keep_rate)
        batch = segs.count2.numel()
        code = (acc / torch.where(z > 0, z, 1.0)[..., None]).reshape(
            batch, -1)
        g2 = torch.from_numpy(gen.normal(0.0, 1.0, (1, batch, w.shape[1]))
                              .astype(np.float32)).cuda().reshape(
            segs.count2.shape + (w.shape[1],))
        gc = (g2 * code.reshape(g2.shape)).sum(dim=-1)
        got = ragged_bwd_parts(args, segs, m, z, gc, g2, keep, keep_rate,
                               tpad, ppad)[0]
        parts.update({'%s %s' % (tag, k): v for k, v in got.items()})

    w_c = params.transform.to(tdtype)
    a_c = params.attention.to(tdtype).reshape(-1)
    tok_rows, path_rows = (params.token_embedding.shape[0],
                           params.path_embedding.shape[0])
    segs = edge_segments(gen, tok_rows, path_rows, tpad, ppad)
    keep = ragged._draw_keep(23, segs, w_c.shape[0], rate)
    run('edges', params.token_embedding, params.path_embedding, w_c, a_c,
        segs, keep, rate)
    segs2 = edge_segments(gen, tok_rows, path_rows, tpad, ppad, shards=2)
    tables = ((params.token_embedding.to(tdtype),
               params.path_embedding.to(tdtype)) if dtype == 'bfloat16'
              else (params.token_embedding, params.path_embedding))
    run('2 shards, %s tables, no mask' % dtype, *tables, w_c, a_c, segs2,
        None, 1.0)
    for k_dim, d_code in ((128, 128), (256, 256), (128, 256), (256, 128)):
        dt, dp = (32, 64) if k_dim == 128 else (64, 128)
        tok, path, w, attn = small_encoder(gen, dt, dp, d_code)
        w, attn = w.to(tdtype), attn.to(tdtype)
        segs_s = edge_segments(gen, 2000, 1000, tpad, ppad, tail=5)
        keep_s = ragged._draw_keep(29, segs_s, k_dim, rate)
        run('K=%d D=%d' % (k_dim, d_code), tok, path, w, attn, segs_s,
            keep_s, rate)
    return parts


def ce_fwd_check(code, w, label, n_valid: int, tag: str) -> float:
    """The CE forward kernel against its plain version (lse and picked,
    rtol and atol 1e-4); returns max |diff|."""
    import torch
    from code2vec_tpu_torch.ops import ce
    got = ce._lse_pick_kernel(code, w, label, n_valid)
    want = ce._lse_pick_plain(code, w, label, n_valid)
    torch.cuda.synchronize()
    for name, g, v in zip(('lse', 'picked'), got, want):
        check(g.shape == v.shape and bool(torch.isfinite(g).all()),
              'ce_fwd %s %s: shape %s or non-finite' % (tag, name,
                                                       tuple(g.shape)))
        torch.testing.assert_close(g, v, rtol=1e-4, atol=1e-4,
                                   msg=lambda m, n=name: 'ce_fwd %s %s: %s'
                                   % (tag, n, m))
    return max_err(got, want)


def ce_fwd_edge_cases(code, w, label, n_valid: int, tdtype) -> dict:
    """The CE forward at the edges of its tiling: a 1,024-row table with
    51 and with 3 valid rows at B = 64, B = 1000 (the last 128-row tile
    partial) over the full table with labels at and past num_valid, and
    code dims 128 and 256 on a 4,096-row table whose
    num_valid (4,000) ends inside a 128-row block, 333 rows, labels over
    every row of the table. num_valid of the main case already ends
    inside a block (261,245 = 2,040 x 128 + 125)."""
    import torch
    errs = {}
    vocab = w.shape[0]
    # the train reference's shape: a 1,024-row table with 51 valid rows
    # (then 3): most vocabulary splits, and some threads' columns, hold
    # masked columns only
    small_w = w[:1024].clone()
    for n_small in (51, 3):
        lab = label[:64] % 64
        errs['V=1024 num_valid=%d' % n_small] = ce_fwd_check(
            code[:64], small_w, lab, n_small, 'V=1024 num_valid=%d'
            % n_small)
    lab = label[:1000].clone()
    lab[:5] = n_valid
    lab[5:9] = vocab - 1
    lab[9] = n_valid - 1
    errs['B=1000'] = ce_fwd_check(code[:1000], w, lab, n_valid, 'B=1000')
    gen = np.random.default_rng(7)
    for d_code in (128, 256):
        code_s, w_s = (torch.from_numpy(gen.normal(0.0, 0.3, shape).astype(
            np.float32)).cuda().to(tdtype) for shape in ((333, d_code),
                                                        (4096, d_code)))
        lab = torch.from_numpy(gen.integers(0, 4096, 333).astype(
            np.int32)).cuda()
        errs['D=%d' % d_code] = ce_fwd_check(code_s, w_s, lab, 4000,
                                             'D=%d' % d_code)
    return errs


def library_ce_fwd(code, w, label, num_valid):
    """The materialized-logits route's forward: one cuBLAS product in the
    compute dtype, then logsumexp and a gather."""
    import torch
    logits = torch.matmul(code, w.T).float()
    logits[:, num_valid:] = -1e9
    return logits, torch.logsumexp(logits, dim=1), torch.gather(
        logits, 1, label.long()[:, None])[:, 0]


def library_ce_bwd(logits, code, w, label, lse, dlse, dpicked):
    """The materialized route's backward from its stored logits: dlogits,
    then two cuBLAS products in the compute dtype."""
    import torch
    dl = dlse[:, None] * torch.exp(logits - lse[:, None])
    dl.scatter_add_(1, label.long()[:, None], dpicked[:, None])
    dl = dl.to(code.dtype)
    return torch.matmul(dl.T, code), torch.matmul(dl, w)


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def record(name: str, source: str, replaces: str, err: float, ms: float,
           plain_ms: float, bound_ms: float, bound_by: str,
           library_ms) -> dict:
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': 0, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms}


def ce_bwd_parts(code, w, label, weight, n_valid: int, lse=None):
    """The CE backward kernel against its plain version at the loss's own
    cotangents (dlse = weight / sum, dpicked = -dlse). The label term of
    dlogits (dpicked, one column per row) is ~|V| times the softmax term,
    so dw's label rows and its other rows are held apart, each on its own
    scale, and a second pass with dpicked = 0 holds the softmax term of
    dcode on its own. Returns (scaled errors by part, max |diff|, the other
    rows' scale over the label rows', the loss pass's arguments)."""
    import torch
    from code2vec_tpu_torch.ops import ce
    if lse is None:
        lse = ce._lse_pick_plain(code, w, label, n_valid)[0]
    dlse = weight / weight.sum()
    dpicked = -dlse
    is_label = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
    is_label[label[(weight > 0) & (label < n_valid)].long()] = True
    parts = {}
    for cot, dp in (('loss', dpicked), ('softmax', torch.zeros_like(
            dpicked))):
        args_c = (code, w, label, lse, dlse, dp, n_valid)
        got = ce._ce_grads_kernel(*args_c)
        want = ce._ce_grads_plain(*args_c)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got),
              'non-finite ce_bwd output')
        parts[cot + ' dw label rows'] = scaled_err(
            [got[0][is_label]], [want[0][is_label]])
        parts[cot + ' dw other rows'] = scaled_err(
            [got[0][~is_label]], [want[0][~is_label]])
        parts[cot + ' dcode'] = scaled_err(got[1:], want[1:])
        if cot == 'loss':
            grad_args = args_c
            abs_err = max_err(got, want)
            other_scale = (float(want[0][~is_label].abs().max())
                           / float(want[0][is_label].abs().max()))
        del got, want
    return parts, abs_err, other_scale, grad_args


def ce_bwd_edge_cases(code, w, label, weight, n_valid: int, tdtype) -> dict:
    """The CE backward at the edges of its tiling, each part as in
    ce_bwd_parts: B = 1000 (the last 64-row tile partial) over the full
    table with labels at and past num_valid (masked columns: no label
    term), and code dims 128 and 256 on a 4,096-row table whose num_valid
    (4,000) ends inside a 64-row block. num_valid of the main case already
    ends inside a block (261,245 = 4,081 x 64 + 61)."""
    import torch
    vocab = w.shape[0]
    parts = {}
    lab = label[:1000].clone()
    lab[:5] = n_valid
    lab[5:9] = vocab - 1
    got = ce_bwd_parts(code[:1000], w, lab, weight[:1000], n_valid)[0]
    parts.update({'B=1000 ' + k: v for k, v in got.items()})
    gen = np.random.default_rng(7)
    for d_code in (128, 256):
        code_s, w_s = (torch.from_numpy(gen.normal(0.0, 0.3, shape).astype(
            np.float32)).cuda().to(tdtype) for shape in ((333, d_code),
                                                        (4096, d_code)))
        lab = torch.from_numpy(gen.integers(0, 4096, 333).astype(
            np.int32)).cuda()
        got = ce_bwd_parts(code_s, w_s, lab, torch.ones(333, device='cuda'),
                           4000)[0]
        parts.update({'D=%d %s' % (d_code, k): v for k, v in got.items()})
    return parts


# the fp32 CE kernels against float64 (ce_float64_checks): a 128-row slice
# of the batch over the whole table; each output's error may be at most
# CE_F64_FACTOR times the plain fp32 version's own; the fp32 encode and
# ragged backward are held to the same factor (F64_FACTOR)
CE_F64_ROWS = 128
CE_F64_FACTOR = 4.0
F64_FACTOR = CE_F64_FACTOR


def ce_float64_checks(code, w, label, weight, n_valid: int) -> dict:
    """The fp32 CE kernels (three TF32 terms) and their plain versions
    (fp32 cuBLAS, TF32 off) against float64 on the first CE_F64_ROWS rows
    of the batch over the whole table, at the loss's cotangents and the
    float64 lse as the backward's residual: each output's error (max |diff|
    over max |float64|) of the kernel may be at most CE_F64_FACTOR times
    the plain version's. Returns {output: (kernel error, plain error)}."""
    import torch
    from code2vec_tpu_torch.ops import ce
    rows = CE_F64_ROWS
    code, label, weight = code[:rows], label[:rows], weight[:rows]
    code64, w64 = code.double(), w.double()
    col = torch.arange(w.shape[0], device=w.device)
    valid = col < n_valid
    logits = torch.where(valid, code64 @ w64.T, -1e30)
    lse64 = torch.logsumexp(logits, dim=1)
    onehot = (col[None, :] == label.long()[:, None]) & valid[None, :]
    picked64 = torch.where(onehot, logits, 0.0).sum(dim=1)
    dlse = weight / weight.sum()
    dpicked = -dlse
    dl64 = (dlse.double()[:, None]
            * torch.where(valid, torch.exp(logits - lse64[:, None]), 0.0)
            + dpicked.double()[:, None] * onehot)
    del logits
    want = (lse64, picked64, dl64.T @ code64, dl64 @ w64)
    del dl64
    lse = lse64.float()
    readings = {}
    for tag, fwd, bwd in (('kernel', ce._lse_pick_kernel,
                           ce._ce_grads_kernel),
                          ('plain', ce._lse_pick_plain, ce._ce_grads_plain)):
        got = (fwd(code, w, label, n_valid)
               + bwd(code, w, label, lse, dlse, dpicked, n_valid))
        torch.cuda.synchronize()
        for name, g, v in zip(('lse', 'picked', 'dw', 'dcode'), got, want):
            err = float((g.double() - v).abs().max() / v.abs().max())
            readings.setdefault(name, {})[tag] = err
        del got
    for name, r in readings.items():
        check(r['kernel'] <= CE_F64_FACTOR * r['plain'],
              'ce fp32 %s against float64: kernel %.3g, more than %.0fx the '
              'plain version\'s %.3g' % (name, r['kernel'], CE_F64_FACTOR,
                                         r['plain']))
    return {name: (r['kernel'], r['plain']) for name, r in readings.items()}


def same_bits(fn) -> bool:
    """fn() twice: every output equal bit for bit."""
    import torch
    first, second = fn(), fn()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def train_kernel_phase(backend, rng, gpu: str):
    """Holds the three training kernels (and the forward kernel in its
    training mode) against their plain versions at the java14m training
    shape, fp32 and bf16, the fp32 ragged backward and CE kernels also
    against float64 and for the same bits on two launches; returns the
    JSON records (the bf16 main path's, then the fp32 kernels') and the
    bf16 forward's training-shape numbers."""
    import torch
    from code2vec_tpu_torch.ops import ce, ragged
    config = backend.config
    tpad, ppad = backend.token_pad_index, backend.path_pad_index
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    packed = train_batch(rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS,
                         sizes, tpad, ppad)
    ctx, count, label, weight = device_arrays(packed)
    retained = int(packed.count.sum())
    batch = count.numel()
    segs = ragged._segment_inputs(ctx, count, tpad, ppad)
    params = backend.params                    # the fp32 masters
    k_dim, d_code = params.transform.shape
    rate = config.DROPOUT_KEEP_RATE
    keep = ragged._draw_keep(11, segs, k_dim, rate)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    g2 = torch.randn((1, batch, d_code), generator=gen, device='cuda')
    table = params.target_embedding
    n_valid = backend.num_valid_targets
    dlse = weight / weight.sum()
    dpicked = -dlse
    records = []
    for dtype in ('float32', 'bfloat16'):
        tdtype = getattr(torch, dtype)
        # Limit on each gradient part's scaled error. In bf16 the kernels
        # and the plain versions round the same fp32 values (du, dlogits)
        # to bf16, and a value that sits on a rounding boundary may go
        # either way: one flipped ulp of a dlogit moves a dw row by up to
        # 2^-7 of one term, and the softmax dlogits of a row are all within
        # ~1% of each other, so such flips read up to ~7e-4 of dw's other
        # rows on this data (the CE backward's exponent on the SFU, ~1e-6
        # relative, flips more of them than an accurate expf, ~4e-4).
        # 1e-3 passes them and fails a rounding rule that is off by half
        # an ulp everywhere (~2^-9).
        tol = 1e-4 if dtype == 'float32' else 1e-3
        args = (params.token_embedding, params.path_embedding,
                params.transform.to(tdtype),
                params.attention.to(tdtype).reshape(-1), segs)
        # the forward kernel in training mode: fp32 tables, keep mask
        fwd_kernel = ragged._stats_kernel(*args, tpad, ppad, keep, rate)
        fwd_plain = ragged._stats_plain(*args, tpad, ppad, keep, rate)
        torch.cuda.synchronize()
        for name, g, w in zip(('scores', 'm', 'z', 'acc'), fwd_kernel,
                              fwd_plain):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                       msg=lambda m, n=name: 'train %s %s: %s'
                                       % (dtype, n, m))
        if dtype == 'float32':
            fwd32_record = ragged_fwd_fp32_record(args[:4], segs, keep, rate,
                                                  tpad, ppad, retained, gpu)
        if dtype == 'bfloat16':
            # its time at the training shape, beside its own bound: fp32
            # rows, the mask and the triples in; W and attention (bf16);
            # scores, m, z, acc out
            fwd_err = max_err(fwd_kernel, fwd_plain)
            run_fwd = lambda: ragged._stats_kernel(*args, tpad, ppad, keep,
                                                   rate)
            run_fwd_plain = lambda: ragged._stats_plain(*args, tpad, ppad,
                                                        keep, rate)
            fwd_ms, fwd_plain_ms = cuda_ms(run_fwd), cuda_ms(run_fwd_plain)
            fwd_ms2 = cuda_ms(run_fwd)
            b_ms, b_by = bound(
                retained * (k_dim * 4 + k_dim + 12)
                + (k_dim + 1) * d_code * 2 + ctx.numel() // 3 * 4
                + batch * (2 + d_code) * 4,
                retained * (2 * k_dim * d_code + 4 * d_code), dtype)
            print('kernel ragged_fwd bfloat16, training shape (fp32 masters, '
                  'keep %.2f): B=%d slots=%d max_abs_err=%.3g kernel '
                  '%.4f/%.4f ms, plain %.4f ms (device, graph replay), bound '
                  '%.4f ms (%s) [%s]' % (rate, batch, retained, fwd_err,
                                         fwd_ms, fwd_ms2, fwd_plain_ms, b_ms,
                                         b_by, gpu))
            train_fwd = {'train_shape_ms': fwd_ms,
                         'train_shape_plain_ms': fwd_plain_ms,
                         'train_shape_bound_ms': b_ms,
                         'train_shape_bound_by': b_by,
                         'train_shape_max_abs_err': fwd_err}
        del fwd_kernel
        _scores, m, z, acc = fwd_plain
        code = (acc / torch.where(z > 0, z, 1.0)[..., None]).reshape(
            batch, d_code)
        gc = (g2 * code[None]).sum(dim=-1)
        parts, abs_err, run_kernel, run_plain = ragged_bwd_parts(
            args[:4], segs, m, z, gc, g2, keep, rate, tpad, ppad)
        parts.update(ragged_bwd_edge_cases(params, dtype, rate, tpad, ppad))
        err = worst(*parts.values())
        check(err <= tol, 'ragged_bwd %s disagrees with its plain version: '
              'scaled errors %s, limit %.3g' % (dtype, parts, tol))
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        w_elt = 2 if dtype == 'bfloat16' else 4
        bwd_bytes = (retained * (k_dim * 4 + 12 + k_dim)  # fp32 rows,
                     # triples, mask; W, attention
                     + (k_dim + 1) * d_code * w_elt
                     + batch * (3 + d_code) * 4         # m, z, gc, g
                     + retained * k_dim * 4             # de
                     + (k_dim + 1) * d_code * 4)        # dW, d_attn
        bwd_flops = retained * (6 * k_dim * d_code + 12 * d_code)
        units = 'tf32x3' if dtype == 'float32' else dtype
        b_ms, b_by = bound(bwd_bytes, bwd_flops, units)
        extra = ''
        if dtype == 'float32':
            check(same_bits(run_kernel), 'ragged_bwd float32: two launches '
                  'differ')
            f64 = ragged_bwd_float64_checks(args[:4], segs, m, z, gc, g2,
                                            keep, rate, tpad, ppad)
            ms2 = cuda_ms(run_kernel)
            extra = (', three-term TF32 at %.0f TFLOP/s, three products; on '
                     'the CUDA cores %.4f ms; the same bits on two launches; '
                     'against float64 (kernel, plain: max |diff| over max '
                     '|float64|, the kernel within %.0fx) %s; kernel again '
                     '%.4f ms'
                     % (PEAK_FLOPS[units] / 1e12,
                        bound(bwd_bytes, bwd_flops, 'float32')[0],
                        F64_FACTOR, {k: (float('%.3g' % a),
                                         float('%.3g' % b))
                                     for k, (a, b) in f64.items()}, ms2))
        print('kernel ragged_bwd %s: B=%d slots=%d keep=%.2f '
              'max_abs_err=%.3g, scaled errors %s (limit %.3g) kernel '
              '%.4f ms, plain %.4f ms (device, graph replay), bound %.4f ms '
              '(%s%s) [%s]'
              % (dtype, batch, retained, rate, abs_err,
                 {k: float('%.3g' % v) for k, v in parts.items()}, tol, ms,
                 plain_ms, b_ms, b_by, extra, gpu))
        bwd_record = record(
            'ragged_bwd' if dtype == 'bfloat16' else 'ragged_bwd_fp32',
            'code2vec_tpu_torch/ops/csrc/ragged_bwd.cu',
            'code2vec_tpu/ops/pallas_ragged.py:486', abs_err, ms, plain_ms,
            b_ms, b_by, None)

        # the streamed CE, at the loss's own cotangents
        code_c = code.to(tdtype)
        w_c = table.to(tdtype)
        vocab = w_c.shape[0]
        abs_err = ce_fwd_check(code_c, w_c, label, n_valid, dtype)
        edge_errs = ce_fwd_edge_cases(code_c, w_c, label, n_valid, tdtype)
        lse = ce._lse_pick_plain(code_c, w_c, label, n_valid)[0]
        ms = cuda_ms(lambda: ce._lse_pick_kernel(code_c, w_c, label,
                                                 n_valid))
        plain_ms = cuda_ms(lambda: ce._lse_pick_plain(code_c, w_c, label,
                                                      n_valid))
        lib_ms = cuda_ms(lambda: library_ce_fwd(code_c, w_c, label, n_valid))
        elt = 2 if dtype == 'bfloat16' else 4
        # the bound at the rate of the units the kernel runs on: fp32 as
        # three TF32 products on the tensor cores, the CUDA-core bound
        # printed beside it
        units = 'tf32x3' if dtype == 'float32' else dtype
        fwd_bytes = (batch + vocab) * d_code * elt + batch * 12
        b_ms, b_by = bound(fwd_bytes, 2.0 * batch * vocab * d_code, units)
        extra = ''
        if dtype == 'float32':
            check(same_bits(lambda: ce._lse_pick_kernel(code_c, w_c, label,
                                                        n_valid)),
                  'ce_fwd float32: two launches differ')
            cc_ms = bound(fwd_bytes, 2.0 * batch * vocab * d_code,
                          'float32')[0]
            extra = (', three-term TF32 at %.0f TFLOP/s; on the CUDA cores '
                     '%.4f ms; the same bits on two launches'
                     % (PEAK_FLOPS[units] / 1e12, cc_ms))
        print('kernel ce_fwd %s: B=%d V=%d D=%d max_abs_err=%.3g (edges, '
              'rtol/atol 1e-4 held: %s) kernel %.4f ms, plain %.4f ms, '
              'materialized logits (cuBLAS) %.4f ms (device, graph replay), '
              'bound %.4f ms (%s%s) [%s]'
              % (dtype, batch, vocab, d_code, abs_err,
                 {k: float('%.3g' % v) for k, v in edge_errs.items()}, ms,
                 plain_ms, lib_ms, b_ms, b_by, extra, gpu))
        fwd_record = record(
            'ce_fwd' if dtype == 'bfloat16' else 'ce_fwd_fp32',
            'code2vec_tpu_torch/ops/csrc/ce.cu',
            'code2vec_tpu/ops/pallas_ce.py:103', abs_err, ms, plain_ms,
            b_ms, b_by, lib_ms)

        parts, abs_err, other_scale, grad_args = ce_bwd_parts(
            code_c, w_c, label, weight, n_valid, lse)
        parts.update(ce_bwd_edge_cases(code_c, w_c, label, weight, n_valid,
                                       tdtype))
        err = worst(*parts.values())
        check(err <= tol, 'ce_bwd %s disagrees with its plain version: '
              'scaled errors %s, limit %.3g' % (dtype, parts, tol))
        ms = cuda_ms(lambda: ce._ce_grads_kernel(*grad_args))
        plain_ms = cuda_ms(lambda: ce._ce_grads_plain(*grad_args))
        logits = library_ce_fwd(code_c, w_c, label, n_valid)[0]
        lib_ms = cuda_ms(lambda: library_ce_bwd(logits, code_c, w_c, label,
                                                lse, dlse, dpicked))
        del logits
        bwd_bytes = ((batch + vocab) * d_code * elt + batch * 16
                     + (batch + vocab) * d_code * 4)
        b_ms, b_by = bound(bwd_bytes, 6.0 * batch * vocab * d_code, units)
        extra = ''
        if dtype == 'float32':
            check(same_bits(lambda: ce._ce_grads_kernel(*grad_args)),
                  'ce_bwd float32: two launches differ')
            cc_ms = bound(bwd_bytes, 6.0 * batch * vocab * d_code,
                          'float32')[0]
            extra = (', three-term TF32 at %.0f TFLOP/s, three products; '
                     'on the CUDA cores %.4f ms; the same bits on two '
                     'launches' % (PEAK_FLOPS[units] / 1e12, cc_ms))
        print('kernel ce_bwd %s: B=%d V=%d D=%d max_abs_err=%.3g, scaled '
              'errors %s (limit %.3g; dw other rows at %.3g of the label '
              'rows\' scale) kernel %.4f ms, plain %.4f ms, '
              'materialized-logits backward (cuBLAS) %.4f ms (device, graph '
              'replay), bound %.4f ms (%s%s) [%s]'
              % (dtype, batch, vocab, d_code, abs_err,
                 {k: float('%.3g' % v) for k, v in parts.items()}, tol,
                 other_scale, ms, plain_ms, lib_ms, b_ms, b_by, extra, gpu))
        bwd_ce_record = record(
            'ce_bwd' if dtype == 'bfloat16' else 'ce_bwd_fp32',
            'code2vec_tpu_torch/ops/csrc/ce.cu',
            'code2vec_tpu/ops/pallas_ce.py:142', abs_err, ms, plain_ms,
            b_ms, b_by, lib_ms)
        if dtype == 'float32':
            f64 = ce_float64_checks(code_c, w_c, label, weight, n_valid)
            print('kernel ce fp32 against float64 (%d rows x V=%d): %s '
                  '(kernel, plain: max |diff| over max |float64|; the '
                  'kernel within %.0fx of the plain version) [%s]'
                  % (CE_F64_ROWS, vocab,
                     {k: (float('%.3g' % a), float('%.3g' % b))
                      for k, (a, b) in f64.items()}, CE_F64_FACTOR, gpu))
            fp32_records = [fwd32_record, bwd_record, fwd_record,
                            bwd_ce_record]
        if dtype == 'bfloat16':    # the training path's compute dtype
            records = [bwd_record, fwd_record, bwd_ce_record] + fp32_records
        torch.cuda.empty_cache()
    return records, train_fwd


TRAIN_KERNELS = ('ragged_fwd', 'ragged_bwd', 'ce_fwd', 'ce_bwd')
# the kernels of every train step: the four above once, Adam once a
# parameter
STEP_KERNELS = TRAIN_KERNELS + ('adam_update',)
PARAMS_PER_STEP = 5


def launch_counts() -> dict:
    """Every kernel wrapper's launch count (``ops.launch_counts``, which
    ``benchlib.kernels_engaged`` reads too)."""
    from code2vec_tpu_torch import ops
    return ops.launch_counts()


def train_counts() -> dict:
    counts = launch_counts()
    check(counts['encode'] == 0 and counts['adam_rows'] == 0,
          'a training path launched the encode or the row-Adam kernel')
    return {name: counts[name] for name in STEP_KERNELS}


def check_step_launches(counts: dict, steps: int, what: str) -> None:
    """Each training kernel once a step, Adam once a parameter."""
    check(all(counts[n] == steps for n in TRAIN_KERNELS)
          and counts['adam_update'] == PARAMS_PER_STEP * steps,
          '%s: kernel launches %s in %d train steps' % (what, counts, steps))


def zero_counts() -> None:
    from code2vec_tpu_torch import ops
    ops.zero_launch_counts()


def train_phase(backend, rng, gpu: str) -> dict:
    """The training main path at java14m width: TRAIN_STEPS steps on one
    pre-packed batch plus one under the CPU-op watch. Returns the launch
    counts of the run."""
    import torch
    from code2vec_tpu_torch.training.trainer import Trainer
    config = backend.config
    trainer = Trainer(config, backend)
    state = trainer.state_from_params()
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    packed = train_batch(rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS,
                         sizes, backend.token_pad_index,
                         backend.path_pad_index)
    arrays = device_arrays(packed)
    examples = int((packed.weight > 0).sum())
    zero_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, arrays)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    watch = CpuOpWatch()
    with watch.mode:
        state, loss = trainer.train_step(state, arrays)
    losses.append(float(loss))
    counts = train_counts()
    steps = TRAIN_STEPS + 1
    check(all(math.isfinite(x) for x in losses), 'non-finite train loss')
    check(losses[-1] < losses[0], 'the loss did not fall on a repeated '
          'batch: %s' % losses)
    check_step_launches(counts, steps, 'train')
    check(not watch.cpu_ops, 'CPU operations on the train step: %s'
          % sorted(set(watch.cpu_ops)))
    step_ms = statistics.median(times[5:])
    print('train: java14m width, B=%d (%d examples), %d slots, bf16, keep '
          '%.2f, fused CE: %d steps, loss %.4f -> %.4f, step %.3f ms (host '
          'clock to synchronize, median of steps 6-%d), %.0f examples/s; '
          'launches %s; no CPU operation on the step [%s]'
          % (config.TRAIN_BATCH_SIZE, examples, int(packed.count.sum()),
             config.DROPOUT_KEEP_RATE, steps, losses[0], losses[-1], step_ms,
             TRAIN_STEPS, examples / step_ms * 1e3, counts, gpu))
    breakdown(trainer, state, arrays, gpu)
    return counts


def breakdown(trainer, state, arrays, gpu: str) -> None:
    """One train step cut at its phase boundaries (host clock, each ending
    in a synchronize): loss forward, backward, Adam."""
    import torch
    from code2vec_tpu_torch.training import adam_dtypes
    from code2vec_tpu_torch.training.trainer import dropout_seed
    params = state.params
    marks = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _aux = trainer.backend.loss_fn_packed(
            params, arrays, dropout_seed(state.seed, state.step))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adam_dtypes.update_(params, [p.grad for p in params],
                            state.opt_state, trainer.config.LEARNING_RATE)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for p in params:
            p.grad = None
        marks.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    fwd, bwd, adam = (statistics.median(m[i] for m in marks)
                      for i in range(3))
    print('train breakdown (median of 3 steps, host clock): forward+loss '
          '%.3f ms, backward %.3f ms, Adam %.3f ms [%s]'
          % (fwd, bwd, adam, gpu))


def unfused_phase(backend, rng, gpu: str) -> None:
    """A few steps with USE_PALLAS_FUSED_CE off: the ragged kernels run,
    the CE goes through materialized logits."""
    import torch
    from code2vec_tpu_torch.training.trainer import Trainer
    trainer = Trainer(backend.config, backend)
    state = trainer.state_from_params()
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    arrays = device_arrays(train_batch(
        rng, backend.config.TRAIN_BATCH_SIZE, backend.config.MAX_CONTEXTS,
        sizes, backend.token_pad_index, backend.path_pad_index))
    zero_counts()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, arrays)
        check(math.isfinite(float(loss)), 'non-finite loss (unfused CE)')
        times.append((time.perf_counter() - t0) * 1e3)
    counts = train_counts()
    check(counts == {'ragged_fwd': 4, 'ragged_bwd': 4, 'ce_fwd': 0,
                     'ce_bwd': 0, 'adam_update': 4 * PARAMS_PER_STEP},
          'launches %s with the unfused CE' % counts)
    print('train, USE_PALLAS_FUSED_CE=False (materialized logits): 4 steps, '
          'step %.3f ms (host clock, median of steps 2-4), launches %s [%s]'
          % (statistics.median(times[1:]), counts, gpu))


FP32_TRAIN_STEPS = 10


def train_fp32_phase(vocabs, prefix: Path, rng, gpu: str) -> dict:
    """The fp32 training main path at java14m width: a Trainer with
    COMPUTE_DTYPE='float32' and the fused CE (B 1024, 200 contexts, keep
    0.75) takes FP32_TRAIN_STEPS steps on one pre-packed batch plus one
    under the CPU-op watch: the loss falls, every step launches the four
    training kernels once (the CE kernels on their three-term TF32 route)
    and Adam once a parameter, no operation runs on the CPU. Returns the
    launch counts of the run."""
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.training.trainer import Trainer
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    USE_PALLAS_FUSED_CE=True, COMPUTE_DTYPE='float32')
    backend = TorchBackend(config, vocabs, torch.device('cuda'), seed=3)
    trainer = Trainer(config, backend)
    state = trainer.state_from_params()
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    packed = train_batch(rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS,
                         sizes, backend.token_pad_index,
                         backend.path_pad_index)
    arrays = device_arrays(packed)
    zero_counts()
    losses, times = [], []
    for _ in range(FP32_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, arrays)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    watch = CpuOpWatch()
    with watch.mode:
        state, loss = trainer.train_step(state, arrays)
    losses.append(float(loss))
    counts = train_counts()
    steps = FP32_TRAIN_STEPS + 1
    check(all(math.isfinite(x) for x in losses), 'non-finite fp32 loss')
    check(losses[-1] < losses[0], 'the fp32 loss did not fall on a repeated '
          'batch: %s' % losses)
    check_step_launches(counts, steps, 'train fp32')
    check(not watch.cpu_ops, 'CPU operations on the fp32 train step: %s'
          % sorted(set(watch.cpu_ops)))
    step_ms = statistics.median(times[3:])
    print('train fp32: java14m width, B=%d, %d slots, COMPUTE_DTYPE float32, '
          'keep %.2f, fused CE (three-term TF32): %d steps, loss %.4f -> '
          '%.4f, step %.3f ms (host clock to synchronize, median of steps '
          '4-%d); launches %s; no CPU operation on the step [%s]'
          % (config.TRAIN_BATCH_SIZE, int(packed.count.sum()),
             config.DROPOUT_KEEP_RATE, steps, losses[0], losses[-1], step_ms,
             FP32_TRAIN_STEPS, counts, gpu))
    del trainer, state, backend
    torch.cuda.empty_cache()
    return counts


ADAM_DTYPES = ('float32', 'bfloat16')
# (gradient, mu, nu) of the main path: fp32 gradients, bf16-stored moments
ADAM_MAIN = ('float32', 'bfloat16', 'bfloat16')
ADAM_EDGE_LAYOUTS = ('aligned', 'offset', 'mixed')


def torch_dtype(name: str):
    import torch
    return {'float32': torch.float32, 'bfloat16': torch.bfloat16}[name]


def bit_mismatches(got, want) -> int:
    """Elements whose bits differ, a NaN on both sides counting as equal
    (a NaN's payload is not part of the function)."""
    import torch
    int_type = torch.int32 if got.dtype == torch.float32 else torch.int16
    differ = got.view(int_type) != want.view(int_type)
    return int((differ & ~(torch.isnan(got) & torch.isnan(want))).sum())


def adam_edge_inputs(rng, combo, layout: str):
    """(p, g, mu, nu) of 1,003 elements (not a multiple of 8) in the
    combo's dtypes: zero, +-3e38 and NaN gradients, +-1e-45 gradients over
    zero moments (m rounds to a signed zero), the rest ordinary. Each
    stream starts 16-byte aligned ('aligned'), one element past it
    ('offset': the kernel's vectors after a scalar prologue), or at
    offsets that never align together ('mixed': scalar throughout)."""
    import torch
    n = 1003
    g = (rng.normal(size=n) * 1e-2).astype(np.float32)
    g[:16] = 0.0
    g[16:32] = rng.choice([-1.0, 1.0], 16) * 3e38
    g[32] = np.nan
    g[33:35] = (1e-45, -1e-45)
    m = (rng.normal(size=n) * 1e-3).astype(np.float32)
    m[33:35] = 0.0
    v = np.abs(rng.normal(size=n) * 1e-5).astype(np.float32)
    p = rng.normal(size=n).astype(np.float32)
    offsets = {'aligned': (0, 0, 0, 0), 'offset': (1, 1, 1, 1),
               'mixed': (1, 3, 2, 5)}[layout]
    out = []
    for values, dtype, offset in zip((p, g, m, v), ('float32',) + combo,
                                     offsets):
        backing = torch.zeros(n + offset, dtype=torch_dtype(dtype),
                              device='cuda')
        backing[offset:] = torch.from_numpy(values).cuda()
        out.append(backing[offset:])
    return out


def adam_param_inputs(gen, shape, combo):
    import torch
    g_dt, mu_dt, nu_dt = (torch_dtype(d) for d in combo)
    kw = dict(generator=gen, device='cuda')
    return [torch.randn(shape, **kw),
            (torch.randn(shape, **kw) * 1e-2).to(g_dt),
            (torch.randn(shape, **kw) * 1e-3).to(mu_dt),
            (torch.rand(shape, **kw) * 1e-5).to(nu_dt)]


def adam_compare(inputs, counts, lr: float) -> tuple:
    """The kernel on ``inputs`` and the plain version on copies, one step
    per count: (bit mismatches of p, mu, nu; max |p diff|)."""
    from code2vec_tpu_torch.ops import adam as adam_ops
    from code2vec_tpu_torch.training import adam_dtypes
    copies = [t.clone() for t in inputs]
    for count in counts:
        s = adam_dtypes.adam_scalars(count, lr)
        adam_ops.adam_update(*inputs, s)
        adam_ops.adam_update_plain(*copies, s)
    mismatches = sum(bit_mismatches(inputs[i], copies[i]) for i in (0, 2, 3))
    diff = (inputs[0] - copies[0]).abs()
    err = float(diff[~diff.isnan()].max()) if diff.numel() else 0.0
    return mismatches, err


def adam_kernel_phase(backend, gpu: str) -> dict:
    """The fused Adam kernel against its plain version on the card, bit
    for bit over every element of every java14m parameter, for every
    gradient x mu x nu dtype, and on the edge inputs (adam_edge_inputs,
    at step 1 then 2); times each dtype combination over the five
    parameters (CUDA graph replay) beside its bound, the plain version and,
    for fp32 moments, ``torch.optim.Adam(fused=True)``. Returns the main
    path's record."""
    import torch
    from code2vec_tpu_torch.ops import adam as adam_ops
    from code2vec_tpu_torch.training import adam_dtypes
    shapes = backend.param_shapes()
    lr = backend.config.LEARNING_RATE
    gen = torch.Generator(device='cuda')
    gen.manual_seed(11)
    rng = np.random.default_rng(11)
    main = None
    for combo in [(g, m, v) for g in ADAM_DTYPES for m in ADAM_DTYPES
                  for v in ADAM_DTYPES]:
        mismatches, elements, err = 0, 0, 0.0
        for layout in ADAM_EDGE_LAYOUTS:
            bad, e = adam_compare(adam_edge_inputs(rng, combo, layout),
                                  (1, 2), lr)
            mismatches += bad
            err = worst(err, e)
            elements += 3 * 1003
        tensors = {name: adam_param_inputs(gen, shape, combo)
                   for name, shape in shapes.items()}
        for name, inputs in tensors.items():
            bad, e = adam_compare([t.clone() for t in inputs], (3,), lr)
            mismatches += bad
            err = worst(err, e)
            elements += 3 * inputs[0].numel()
        check(mismatches == 0, 'adam_update %s: %d of %d elements differ '
              'from the plain version in their bits (max |p diff| %.3g)'
              % (combo, mismatches, elements, err))
        s = adam_dtypes.adam_scalars(3, lr)

        def kernel():
            for p, g, mu, nu in tensors.values():
                adam_ops.adam_update(p, g, mu, nu, s)

        def plain():
            for p, g, mu, nu in tensors.values():
                adam_ops.adam_update_plain(p, g, mu, nu, s)
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        n_params = sum(t[0].numel() for t in tensors.values())
        per_element = 8 + sum(2 * torch_dtype(d).itemsize
                              for d in combo[1:]) + torch_dtype(
                                  combo[0]).itemsize
        b_ms, b_by = bound(n_params * per_element, 0.0, 'float32')
        lib_ms = None
        if combo == ('float32', 'float32', 'float32'):
            params = [t[0].requires_grad_() for t in tensors.values()]
            for p, t in zip(params, tensors.values()):
                p.grad = t[1]
            opt = torch.optim.Adam(params, lr=lr, fused=True)
            opt.step()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                opt.step()
            end.record()
            end.synchronize()
            lib_ms = start.elapsed_time(end) / 10
            del opt, params
        print('kernel adam_update grads %s, mu %s, nu %s: bit-equal to the '
              'plain version over %d elements (every element of the five '
              'java14m parameters, %d values, and the edge inputs at steps '
              '1 and 2); kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s, '
              '%d bytes an element)%s (device, graph replay) [%s]'
              % (combo + (elements, n_params, ms, plain_ms, b_ms, b_by,
                          per_element,
                          '' if lib_ms is None else
                          ', torch.optim.Adam(fused=True) %.4f ms (events)'
                          % lib_ms, gpu)))
        if combo == ADAM_MAIN:
            main = record('adam_update', 'code2vec_tpu_torch/ops/csrc/adam.cu',
                          'code2vec_tpu/training/adam_dtypes.py:78', err,
                          ms, plain_ms, b_ms, b_by, None)
        del tensors
        torch.cuda.empty_cache()
    return main


def library_sparse_adam(table, grad, rows, lr: float):
    """``torch.optim.SparseAdam`` over the touched rows' coalesced sparse
    gradient: its step, timed with CUDA events (the yardstick of
    adam_rows; a fresh optimizer per step, so its step count is 1)."""
    import torch
    unique = torch.unique(rows)
    param = table.clone().requires_grad_()
    param.grad = torch.sparse_coo_tensor(unique[None, :], grad[unique],
                                         table.shape,
                                         check_invariants=False).coalesce()
    times = []
    for _ in range(5):
        opt = torch.optim.SparseAdam([param], lr=lr)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


ROWS_REPEATED = 20000


def adam_rows_phase(backend, rng, gpu: str) -> dict:
    """Lazy Adam's row kernel against its plain version on the card: the
    token table at java14m size (random fp32 table, moments and gradient)
    over the rows of a real packed batch (``packed_rows``: source, target
    and the PAD row) plus one row listed ROWS_REPEATED times (warps that
    updated it twice would race) and entries outside the table (skipped);
    from the list and from its mask (``touched_mask``, a mesh's form):
    touched rows equal the plain version's bit for bit, untouched rows keep
    their bits. Times the call from the list, and apart its mark step (the
    list into the mask, in place of the parent's sort, timed beside it)
    and the row kernel from the mask. Returns the record."""
    import torch
    from code2vec_tpu_torch.ops import adam as adam_ops
    from code2vec_tpu_torch.ops import lazy_adam
    from code2vec_tpu_torch.training.trainer import packed_rows
    config = backend.config
    tpad, ppad = backend.token_pad_index, backend.path_pad_index
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    packed = train_batch(rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS,
                         sizes, tpad, ppad)
    ctx = torch.from_numpy(packed.ctx).cuda()
    source, _path, target = packed_rows(ctx, tpad, ppad)
    shape = backend.param_shapes()['token_embedding']
    rows = torch.cat([source, target, torch.full(
        (ROWS_REPEATED,), 4321, dtype=source.dtype, device='cuda'),
        torch.tensor([-1, shape[0], -7], dtype=source.dtype,
                     device='cuda')]).long()
    inside = rows[(rows >= 0) & (rows < shape[0])]
    mask = lazy_adam.touched_mask(rows, shape[0])
    gen = torch.Generator(device='cuda')
    gen.manual_seed(12)
    kw = dict(generator=gen, device='cuda')
    start = [torch.randn(shape, **kw), torch.randn(shape, **kw) * 1e-3,
             torch.rand(shape, **kw) * 1e-5]
    grad = torch.randn(shape, **kw) * 1e-2
    lr, step = config.LEARNING_RATE, 3
    want = [t.clone() for t in start]
    lazy_adam.sparse_row_adam_plain(
        *want, grad, inside, lazy_adam.lazy_rate(lr, step))
    unique = int(mask.sum())
    readings = {}
    for tag, given in (('list', rows), ('mask', mask)):
        got = [t.clone() for t in start]
        lazy_adam.sparse_row_adam(*got, grad, given, learning_rate=lr,
                                  step=step)
        mismatches = sum(bit_mismatches(g, w) for g, w in zip(got, want))
        moved = sum(bit_mismatches(g[~mask], s[~mask])
                    for g, s in zip(got, start))
        err = max_err(got, want)
        check(mismatches == 0 and moved == 0, 'adam_rows from the %s: %d '
              'elements differ from the plain version, %d untouched '
              'elements changed (max err %.3g)'
              % (tag, mismatches, moved, err))
        readings[tag] = err
    ms = cuda_ms(lambda: lazy_adam.sparse_row_adam(
        *got, grad, rows, learning_rate=lr, step=step))
    mark_ms = cuda_ms(lambda: adam_ops._row_mask(rows, shape[0]))
    mask_ms = cuda_ms(lambda: lazy_adam.sparse_row_adam(
        *got, grad, mask, learning_rate=lr, step=step))
    sort_ms = cuda_ms(lambda: torch.sort(rows))
    plain_ms = cuda_ms(lambda: lazy_adam.sparse_row_adam_plain(
        *want, grad, inside, lazy_adam.lazy_rate(lr, step)))
    lib_ms = library_sparse_adam(start[0], grad, inside, lr)
    b_ms, b_by = bound(unique * shape[1] * 28 + rows.numel() * 8, 0.0,
                       'float32')
    print('kernel adam_rows: token table %s fp32, %d listed rows (%d '
          'distinct; one row %d times; 3 outside the table) of a packed '
          'batch: bit-equal to the plain version from the list and from '
          'its mask, untouched rows unchanged; kernel from the list %.4f ms '
          '= the mark step (list into mask) %.4f ms + the row kernel from '
          'the mask %.4f ms (the parent\'s torch.sort of the list %.4f ms); '
          'plain %.4f ms (graph replay), torch.optim.SparseAdam step %.4f '
          'ms (events), bound %.4f ms (%s) [%s]'
          % (tuple(shape), rows.numel(), unique, ROWS_REPEATED, ms, mark_ms,
             mask_ms, sort_ms, plain_ms, lib_ms, b_ms, b_by, gpu))
    del got, want, start, grad
    torch.cuda.empty_cache()
    return record('adam_rows', 'code2vec_tpu_torch/ops/csrc/adam.cu',
                  'code2vec_tpu/ops/lazy_adam.py:65',
                  max(readings.values()), ms, plain_ms, b_ms, b_by, lib_ms)


class SyncWatch:
    """Raises at any host synchronization of the card's stream inside the
    block (``torch.cuda.set_sync_debug_mode('error')``)."""

    def __enter__(self):
        import torch
        self.before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode('error')
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(self.before)
        return False


KNOB_STEPS = 6
KNOB_TIMED_STEPS = 10
# (name, Config knobs, adam_update and adam_rows launches a step, ragged
# forward launches a step); 'default' is the same phase with no knob, the
# step time the others compare with
KNOBS = (('default', {}, 5, 0, 1),
         ('lazy', dict(LAZY_EMBEDDING_ADAM=True), 3, 2, 1),
         ('grads_bf16', dict(GRADS_DTYPE='bfloat16'), 5, 0, 1),
         ('sorted', dict(EMBED_GRAD_IMPL='sorted'), 5, 0, 1),
         ('dedup', dict(EMBED_GRAD_IMPL='dedup'), 5, 0, 1),
         ('remat', dict(REMAT_ENCODE=True), 5, 0, 2))


def table_grads(trainer, state, arrays):
    """The token and path tables' gradients of one step's loss (the
    trainer's route: bf16 copies under GRADS_DTYPE='bfloat16')."""
    import torch
    from code2vec_tpu_torch.models.functional import Code2VecParams
    from code2vec_tpu_torch.training.trainer import dropout_seed
    params = state.params
    if trainer.grads_bf16:
        params = Code2VecParams(*[p.detach().to(torch.bfloat16)
                                  .requires_grad_() for p in params])
    for p in params:
        p.grad = None
    loss, _aux = trainer.backend.loss_fn_packed(
        params, arrays, dropout_seed(state.seed, state.step))
    loss.backward()
    grads = [params[i].grad.clone() for i in (0, 1)]
    for p in params:
        p.grad = None
    return grads


def empty_example_arrays(backend, rng):
    """A packed batch with no PAD slot in its stream (every context drawn
    off the PAD rows, capacity exactly the total) and one empty example of
    weight 1, whose code vector x_pad sends a gradient to the PAD rows."""
    import torch
    batch = backend.config.TRAIN_BATCH_SIZE
    count = context_counts(rng, batch, backend.config.MAX_CONTEXTS)
    count[7] = 0
    total = int(count.sum())

    def draw(rows, pad):
        x = rng.integers(0, rows - 1, total)
        return np.where(x >= pad, x + 1, x)
    tok_rows = backend.sizes['token_vocab_size']
    ctx = np.stack([draw(tok_rows, backend.token_pad_index),
                    draw(backend.sizes['path_vocab_size'],
                         backend.path_pad_index),
                    draw(tok_rows, backend.token_pad_index)],
                   axis=-1).astype(np.int32)[None]
    label = rng.integers(1, backend.num_valid_targets, batch)
    return tuple(torch.from_numpy(a).cuda() for a in (
        ctx, count.astype(np.int32), label.astype(np.int32),
        np.ones(batch, np.float32)))


def knob_phase(name: str, knobs: dict, vocabs, prefix: Path, rng,
               gpu: str) -> dict:
    """One optimizer or table-gradient knob at java14m width (fused CE,
    bf16, keep 0.75): KNOB_STEPS steps on one batch under the CPU-op watch
    and the sync watch; the loss falls, each step launches the expected
    kernels, and the step time (CUDA events between steps' ends, queued
    back to back) is printed, with whether the table gradients repeat bit
    for bit from the same state. Lazy Adam also takes a step on a batch
    whose stream holds no PAD slot but an empty example of weight 1: the
    PAD rows, touched only through ``packed_rows``' append, must move.
    Returns the launch counts."""
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.training.trainer import Trainer
    _name, _knobs, adam_n, rows_n, fwd_n = next(k for k in KNOBS
                                                if k[0] == name)
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    USE_PALLAS_FUSED_CE=True, **knobs)
    backend = TorchBackend(config, vocabs, torch.device('cuda'), seed=1)
    trainer = Trainer(config, backend)
    state = trainer.state_from_params()
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    arrays = device_arrays(train_batch(
        rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS, sizes,
        backend.token_pad_index, backend.path_pad_index))
    first = table_grads(trainer, state, arrays)
    second = table_grads(trainer, state, arrays)
    repeat = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    dtypes = [str(g.dtype).replace('torch.', '') for g in first]
    del first, second
    state, loss = trainer.train_step(state, arrays)     # warm
    losses = [loss]
    watch = CpuOpWatch()
    zero_counts()
    with SyncWatch(), watch.mode:
        for _ in range(KNOB_STEPS):
            state, loss = trainer.train_step(state, arrays)
            losses.append(loss)
    counts = launch_counts()
    # the device time of a step, outside the watches (whose per-op Python
    # would set the pace): steps queued back to back, events at their ends
    ends = []
    for _ in range(KNOB_TIMED_STEPS):
        state, loss = trainer.train_step(state, arrays)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
    losses.append(loss)
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    step_ms = statistics.median(a.elapsed_time(b)
                                for a, b in zip(ends[1:], ends[2:]))
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          'knob %s: losses %s' % (name, losses))
    check(not watch.cpu_ops, 'knob %s: CPU operations on the step: %s'
          % (name, sorted(set(watch.cpu_ops))))
    expected = dict({k: 0 for k in counts}, ragged_fwd=fwd_n * KNOB_STEPS,
                    ragged_bwd=KNOB_STEPS, ce_fwd=KNOB_STEPS,
                    ce_bwd=KNOB_STEPS, adam_update=adam_n * KNOB_STEPS,
                    adam_rows=rows_n * KNOB_STEPS)
    check(counts == expected, 'knob %s: launches %s, expected %s'
          % (name, counts, expected))
    pad_text = ''
    if name == 'lazy':
        empty = empty_example_arrays(backend, rng)
        tables = ('token_embedding', 'path_embedding')
        pads = (backend.token_pad_index, backend.path_pad_index)
        before = [float(state.opt_state.mu[t][pad].abs().sum())
                  for t, pad in zip(tables, pads)]
        state, _loss = trainer.train_step(state, empty)
        after = [float(state.opt_state.mu[t][pad].abs().sum())
                 for t, pad in zip(tables, pads)]
        check(before == [0.0, 0.0] and all(a > 0 for a in after),
              'lazy Adam: the PAD rows\' first moments %s -> %s on a batch '
              'with an empty example of weight 1 and no PAD slot'
              % (before, after))
        pad_text = ('; an empty example of weight 1 moved both PAD rows '
                    '(|mu| sums %s)' % ['%.3g' % a for a in after])
    print('knob %s %s: java14m width, fused CE, bf16, keep %.2f: %d steps '
          'on one batch, loss %.4f -> %.4f, step %.3f ms (median of %d, CUDA '
          'events between steps\' ends, queued back to back); no CPU op and '
          'no host sync on %d watched steps; launches %s; table gradients '
          '(%s) repeat bit for bit from the same state: token %s, path %s%s '
          '[%s]' % (name, knobs, config.DROPOUT_KEEP_RATE,
                    1 + KNOB_STEPS + KNOB_TIMED_STEPS, losses[0], losses[-1],
                    step_ms, KNOB_TIMED_STEPS - 2, KNOB_STEPS, counts,
                    '/'.join(dtypes), repeat[0], repeat[1], pad_text, gpu))
    del backend, trainer, state, arrays
    torch.cuda.empty_cache()
    return counts


def knob_phases(vocabs, prefix: Path, gpu: str) -> dict:
    """Every knob of KNOBS (knob_phase), each on batches of its own
    generator; returns {'train_<knob>': launch counts}."""
    return {'train_' + name: knob_phase(name, knobs, vocabs, prefix,
                                        np.random.default_rng(20 + i), gpu)
            for i, (name, knobs, *_n) in enumerate(KNOBS)}


def train_entry_phase(prefix: Path, vocab_sizes, rng, gpu: str) -> dict:
    """``Code2VecModel(device='cuda').train()`` over a synthetic train
    split at java14m width, then a predict with the trained weights."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    lines = make_lines(rng, 2100, vocab_sizes, 200)
    with open(str(prefix) + '.train.c2v', 'w') as f:
        f.write('\n'.join(lines) + '\n')
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix), NUM_TRAIN_EPOCHS=1,
                    USE_PALLAS_FUSED_CE=True, NUM_BATCHES_TO_LOG_PROGRESS=1)
    model = Code2VecModel(config, device='cuda', seed=5)
    zero_counts()
    t0 = time.perf_counter()
    losses = model.train()
    seconds = time.perf_counter() - t0
    counts = train_counts()
    steps = model.state.step
    check(steps == 3 and all(math.isfinite(x) for x in losses),
          'train() took %d steps, losses %s' % (steps, losses))
    check_step_launches(counts, steps, 'train()')
    results = model.predict(lines[:8])
    check(all(np.isfinite(r.topk_predicted_words_scores).all()
              for r in results), 'bad predict after train()')
    print('train entry: Code2VecModel.train() over %d lines, %d steps, mean '
          'loss %.4f, %.1f s with host tokenization; launches %s; predict '
          'after train() ok [%s]' % (len(lines), steps, losses[0], seconds,
                                     counts, gpu))
    return counts


def moment_readings(got: dict, want: dict) -> dict:
    """The card's Adam moments against the CPU's, per moment and
    parameter ({moment: {parameter: readings}}): ``scaled`` (max |got -
    want| over max |want|), ``rel`` (||got - want|| / ||want||) and
    ``scale`` (|<got, want> / <want, want> - 1|). Adam's update
    m / sqrt(v) does not change when every gradient is off by one factor;
    the moments carry that factor."""
    out = {}
    for moment in ('mu', 'nu'):
        out[moment] = {}
        for name, w in want[moment].items():
            g = got[moment][name].astype(np.float64)
            w = w.astype(np.float64)
            w_sq = max(float((w * w).sum()), 1e-300)
            out[moment][name] = {
                'scaled': float(np.abs(g - w).max()
                                / max(np.abs(w).max(), 1e-300)),
                'rel': math.sqrt(float(((g - w) ** 2).sum()) / w_sq),
                'scale': abs(float((g * w).sum()) / w_sq - 1.0)}
    return out


def worst_moment_readings(by_param: dict) -> dict:
    """moment_readings' readings, the worst over the parameters:
    {moment: readings}."""
    return {moment: {key: worst(*(r[key] for r in params.values()))
                     for key in ('scaled', 'rel', 'scale')}
            for moment, params in by_param.items()}


# card-vs-CPU train reference limits per compute dtype. fp32: one bf16 ulp
# of the stored moments (2^-7 of the largest) may flip where the two
# gradients straddle a rounding boundary, and nothing else differs by more
# than the fp32 summation order; in a small tensor (the attention vector's
# 384 moments) one such flip reads ~1e-5 on the scale and ~3e-4 on rel.
# The rel and scale limits come from ten draws of batches (generators
# seeded 101-110) on an H100 with the fp32 kernels of three TF32 terms
# (PERF.md), both before and after the ragged forward's move to them
# (largest: scale 1.81e-5, rel 3.24e-4, both in the attention vector's
# mu), and the smoke's own draw (scale 1.74e-5, rel 4.96e-4): they sit
# ~3x above the largest readings. Every gradient on the card x1.01 reads
# ~1.0e-2 on mu's scale and rel and ~2.0e-2 on nu's, 7x above the rel
# limit and 170x above the scale limit. The scaled limit (one ulp; largest
# reading 4.9e-3, the control 1.5e-2), the loss (largest 1.2e-7) and the
# weights elementwise to a tenth of one Adam step (lr 1e-3; largest 5.2e-5,
# the smoke's own draw) stay as they were.
# bf16: the kernels and the plain versions round the same values to bf16,
# so the gradients differ where one bf16 ulp flips (up to two ulps of the
# stored moments, 2^-6), and an element whose gradient is near zero on
# both sides may take Adam steps of the other sign (m / sqrt(v) ~ sign(g)
# over three steps), so the weights' update is held in norm, not per
# element, and that norm moves with the draw of batches. The bf16 limits
# come from ten draws of batches (generators seeded 101-110) on an H100
# (PERF.md), whose largest readings were: Adam moments scaled 6.5e-3,
# rel 1.23e-3, scale 1.49e-4; update norm 2.04e-3; loss 3.6e-7. The rel,
# scale and update-norm limits sit ~3x above their largest readings; the
# scaled and loss limits stay as they were (2.4x and ~300x above). Every
# gradient on the card x1.01 reads ~1.0e-2 on mu's scale and rel and
# ~2.0e-2 on nu's, 20x and 2.5x above those limits; the scaled error (one
# bf16 ulp, 2^-6) and the update norm do not see such a fault (Adam's
# m / sqrt(v) does not change).
TRAIN_REF_LIMITS = {
    'float32': {'loss': 1e-5, 'scaled': 2.0 ** -7, 'rel': 1.5e-3,
                'scale': 6e-5, 'weights': 1e-4},
    'bfloat16': {'loss': 1e-4, 'scaled': 2.0 ** -6, 'rel': 4e-3,
                 'scale': 5e-4, 'weights': 6e-3},
}
TRAIN_REF_DRAWS = (101, 102, 103)   # bf16: the seed of each draw's generator


def train_reference_readings(dtype: str, rng) -> dict:
    """A small-vocabulary model at full width trains three steps on the
    card and on the CPU (plain versions) from the same weights and the
    same batches (drawn from ``rng``) at keep 1.0. Returns the card's
    readings against the CPU: loss (relative, worst step), the Adam
    moments (moment_readings: ``moments_by_param``, and the worst over
    the parameters, ``moments``) and the weights (fp32: max |diff|; bf16:
    ||diff|| / ||update||)."""
    import torch
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.training.trainer import Trainer
    from code2vec_tpu_torch.vocab import Code2VecVocabs
    prefix = SMOKE_DIR / 'small'
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix), COMPUTE_DTYPE=dtype,
                    DROPOUT_KEEP_RATE=1.0, USE_PALLAS_FUSED_CE=True,
                    TRAIN_BATCH_SIZE=64)
    vocabs = Code2VecVocabs(config)
    cpu = TorchBackend(config, vocabs, torch.device('cpu'), seed=3)
    start = {name: a.copy() for name, a in
             convert.params_to_numpy(cpu.params).items()}
    gpu_backend = TorchBackend(config, vocabs, torch.device('cuda'),
                               params=convert.params_from_numpy(start, 'cuda'))
    trainers = (Trainer(config, cpu), Trainer(config, gpu_backend))
    states = [t.state_from_params() for t in trainers]
    sizes = (vocabs.token_vocab.size, vocabs.path_vocab.size,
             vocabs.target_vocab.size)
    loss_err = 0.0
    for _ in range(3):
        packed = train_batch(rng, 64, config.MAX_CONTEXTS, sizes,
                             cpu.token_pad_index, cpu.path_pad_index)
        losses = []
        for i, trainer in enumerate(trainers):
            states[i], loss = trainer.train_step(states[i], packed)
            losses.append(float(loss))
        loss_err = worst(loss_err,
                         abs(losses[0] - losses[1]) / abs(losses[0]))
    by_param = moment_readings(
        convert.opt_state_to_numpy(states[1].opt_state),
        convert.opt_state_to_numpy(states[0].opt_state))
    want = convert.params_to_numpy(states[0].params)
    got = convert.params_to_numpy(states[1].params)
    if dtype == 'float32':
        weights = worst(*(float(np.abs(got[n] - want[n]).max())
                          for n in want))
    else:
        weights = worst(*(math.sqrt(
            float(((got[n].astype(np.float64) - want[n]) ** 2).sum())
            / max(float(((want[n].astype(np.float64) - start[n]) ** 2
                         ).sum()), 1e-300)) for n in want))
    return {'loss': loss_err, 'moments': worst_moment_readings(by_param),
            'moments_by_param': by_param, 'weights': weights,
            'got': got, 'want': want}


def train_reference_phase(rng) -> None:
    """The train reference (train_reference_readings) in fp32 on batches
    from ``rng`` and in bf16 on TRAIN_REF_DRAWS draws, each from its own
    generator: losses, Adam moments and weights agree within
    TRAIN_REF_LIMITS."""
    runs = [('float32', 'shared', rng)] + [
        ('bfloat16', seed, np.random.default_rng(seed))
        for seed in TRAIN_REF_DRAWS]
    for dtype, draw, gen in runs:
        limits = TRAIN_REF_LIMITS[dtype]
        r = train_reference_readings(dtype, gen)
        check(r['loss'] <= limits['loss'], '%s (draw %s) loss on the card '
              'vs the CPU: relative error %.3g > %.3g'
              % (dtype, draw, r['loss'], limits['loss']))
        for moment, readings in r['moments'].items():
            for key, value in readings.items():
                check(value <= limits[key], '%s (draw %s) Adam %s on the '
                      'card vs the CPU: %s %.3g > %.3g (by parameter: %s)'
                      % (dtype, draw, moment, key, value, limits[key],
                         r['moments_by_param']))
        if dtype == 'float32':
            for name in r['want']:
                np.testing.assert_allclose(r['got'][name], r['want'][name],
                                           rtol=limits['weights'],
                                           atol=limits['weights'],
                                           err_msg=name)
            weights_text = 'max |diff| %.3g (limit rtol/atol %.3g)' % (
                r['weights'], limits['weights'])
        else:
            check(r['weights'] <= limits['weights'], 'bf16 (draw %s) weight '
                  'updates on the card vs the CPU: relative error %.3g > '
                  '%.3g' % (draw, r['weights'], limits['weights']))
            weights_text = ('update ||diff||/||update|| %.3g (limit %.3g)'
                            % (r['weights'], limits['weights']))
        print('train reference %s (draw %s): 3 steps of a 300/200/50-word '
              'model at full width, fused CE, keep 1.0, card vs CPU plain '
              'path: loss rel err %.3g (limit %.3g); Adam moments %s '
              '(limits %s); weights %s' % (
                  dtype, draw, r['loss'], limits['loss'],
                  {m: {k: float('%.3g' % v) for k, v in rd.items()}
                   for m, rd in r['moments'].items()},
                  {k: limits[k] for k in ('scaled', 'rel', 'scale')},
                  weights_text))


# the resumed run against the run continued in memory: the same bf16
# kernels on the same card, apart in the order of the table gradients'
# atomic adds (index_add_), held to the card-vs-CPU bf16 limits, which
# also cover gradients that differ by flipped bf16 ulps
RESUME_LIMITS = TRAIN_REF_LIMITS['bfloat16']
CKPT_EPOCHS = 3


def state_equal(a, b) -> bool:
    """Two training states (or a state and a restored one, as {name:
    tensor} dicts) hold equal tensors in equal dtypes."""
    import torch
    from code2vec_tpu_torch.models.functional import Code2VecParams
    names = Code2VecParams._fields

    def named(state, field):
        if hasattr(state, 'opt_state'):
            if field == 'params':
                return dict(zip(names, state.params))
            return dict(zip(names, getattr(state.opt_state, field)))
        return state[field]

    for field in ('params', 'mu', 'nu'):
        x, y = named(a, field), named(b, field)
        for name in names:
            u, v = x[name].detach(), y[name].detach()
            if u.dtype != v.dtype or not torch.equal(u, v.to(u.device)):
                return False
    return True


def resume_readings(got, want, start) -> dict:
    """A resumed state against the one continued in memory, on the card in
    float64: the Adam moments (``moment_readings``' keys) and the weights'
    update (||got - want|| / ||want - start||, the worst parameter)."""
    import torch
    out = {'mu': {'scaled': 0.0, 'rel': 0.0, 'scale': 0.0},
           'nu': {'scaled': 0.0, 'rel': 0.0, 'scale': 0.0}}
    for moment in ('mu', 'nu'):
        readings = out[moment]
        for g, w in zip(getattr(got.opt_state, moment),
                        getattr(want.opt_state, moment)):
            g, w = g.double(), w.double()
            w_sq = max(float((w * w).sum()), 1e-300)
            readings['scaled'] = worst(readings['scaled'], float(
                (g - w).abs().max() / max(float(w.abs().max()), 1e-300)))
            readings['rel'] = worst(readings['rel'], math.sqrt(
                float(((g - w) ** 2).sum()) / w_sq))
            readings['scale'] = worst(readings['scale'], abs(
                float((g * w).sum()) / w_sq - 1.0))
    update = 0.0
    with torch.no_grad():
        for g, w, s in zip(got.params, want.params, start):
            diff = float(((g.double() - w.double()) ** 2).sum())
            moved = max(float(((w.double() - s.double()) ** 2).sum()),
                        1e-300)
            update = worst(update, math.sqrt(diff / moved))
    out['weights'] = update
    return out


def checkpoint_phase(prefix: Path, test_path: Path, gpu: str) -> dict:
    """Saves, a reload, the release and a resume at java14m width and
    vocabulary with the fused CE, in a temporary directory under
    build/smoke/ that it removes. ``Code2VecModel.train()`` runs
    CKPT_EPOCHS epochs of three steps over train entry's split, saving
    each epoch (MAX_TO_KEEP=2) and evaluating after it; a params-only
    reload evaluates and predicts bit for bit as the model in memory; the
    newest step restores equal to the trained state; the release has no
    moments and loads under the plain route's 261,248 target rows; a
    resumed model trains the next epoch within RESUME_LIMITS of the model
    continued in memory. Times the saves and the restore. Returns the
    launches per path."""
    import torch
    from code2vec_tpu_torch import checkpoints
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.cache import TokenCache
    from code2vec_tpu_torch.data.reader import PathContextReader
    from code2vec_tpu_torch.model_api import Code2VecModel
    root = Path(tempfile.mkdtemp(prefix='checkpoints_', dir=SMOKE_DIR))
    save = root / 'm' / 'saved_model'
    train = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), USE_PALLAS_FUSED_CE=True)
    by_path = {}
    try:
        model = Code2VecModel(Config(
            TEST_DATA_PATH=str(test_path), NUM_TRAIN_EPOCHS=CKPT_EPOCHS,
            MAX_TO_KEEP=2, MODEL_SAVE_PATH=str(save), **train),
            device='cuda', seed=7)
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        train_s = time.perf_counter() - t0
        by_path['checkpoint_train'] = launch_counts()
        steps = model.state.step
        store = model._store_for(str(save))
        check(store.steps() == [steps - 3, steps] and steps == 3 * CKPT_EPOCHS,
              'retained steps %s after %d steps (MAX_TO_KEEP=2)'
              % (store.steps(), steps))
        entire = Path(store.entire_dir) / str(steps) / \
            checkpoints.CHECKPOINT_FILE
        # a timed save of the same state (replaces the newest step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.save(epoch=CKPT_EPOCHS - 1)
        save_s = time.perf_counter() - t0
        save_gb = entire.stat().st_size / 1e9
        # where a save's time goes: the card -> host copy, then torch.save
        state = model.state
        tensors = (list(state.params) + list(state.opt_state.mu)
                   + list(state.opt_state.nu))
        t0 = time.perf_counter()
        host = [t.detach().cpu() for t in tensors]
        d2h_s = time.perf_counter() - t0
        probe = root / 'probe.pt'
        t0 = time.perf_counter()
        torch.save(host, probe)
        write_s = time.perf_counter() - t0
        probe.unlink()
        del host, tensors, state
        # disk (page cache) -> host -> card
        t0 = time.perf_counter()
        restored = store.restore_training()
        on_card = {field: {name: t.to('cuda') for name, t in named.items()}
                   for field, named in (('params', restored.params),
                                        ('mu', restored.opt_state['mu']),
                                        ('nu', restored.opt_state['nu']))}
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(state_equal(model.state, on_card)
              and restored.opt_state['count'] == model.state.opt_state.count
              and restored.step == steps
              and restored.epoch == CKPT_EPOCHS - 1,
              'the restored training state differs from the saved one')
        del restored, on_card
        lines = test_path.read_text().splitlines()[:64]
        want_predict = model.predict(lines)
        want_eval = model.eval_history[-1]

        t0 = time.perf_counter()
        reload = Code2VecModel(Config(
            MODEL_LOAD_PATH=str(save), TEST_DATA_PATH=str(test_path),
            USE_PALLAS_FUSED_CE=True), device='cuda')
        reload_s = time.perf_counter() - t0
        check(reload.state is None, 'a params-only reload holds moments')
        zero_counts()
        got = reload.evaluate()
        got_predict = reload.predict(lines)
        by_path['reload_eval'] = launch_counts()
        check([float(x) for x in got.topk_acc] == want_eval['topk_acc']
              and (got.subtoken_precision, got.subtoken_recall,
                   got.subtoken_f1, got.loss)
              == (want_eval['precision'], want_eval['recall'],
                  want_eval['f1'], want_eval['loss']),
              'the reload evaluates %s, the model in memory %s'
              % (got, want_eval))
        for g, w in zip(got_predict, want_predict):
            check(g.topk_predicted_words == w.topk_predicted_words
                  and np.array_equal(g.topk_predicted_words_scores,
                                     w.topk_predicted_words_scores),
                  'the reload predicts otherwise than the model in memory')
        t0 = time.perf_counter()
        reload.release_model()
        release_s = time.perf_counter() - t0
        released = Path(store.weights_dir) / checkpoints.CHECKPOINT_FILE
        release_gb = released.stat().st_size / 1e9
        check(set(torch.load(released, weights_only=True, mmap=True))
              == {'params'}, 'the release holds more than the params')
        del reload
        plain = Code2VecModel(Config(MODEL_LOAD_PATH=str(save)),
                              device='cuda')
        rows = plain.backend.sizes['target_vocab_size']
        check(rows == 261248 and plain.state is None and all(
            torch.equal(got_t, want_t[:got_t.shape[0]].detach())
            for got_t, want_t in zip(plain.backend.params,
                                     model.state.params)),
              'the release under the plain route (%d target rows) differs '
              'from the trained weights' % rows)
        del plain
        torch.cuda.empty_cache()

        resumed = Code2VecModel(Config(
            MODEL_LOAD_PATH=str(save), TEST_DATA_PATH=str(test_path),
            NUM_TRAIN_EPOCHS=CKPT_EPOCHS + 1, **train), device='cuda')
        check(resumed._start_epoch == CKPT_EPOCHS
              and resumed.state.step == steps
              and state_equal(resumed.state, model.state),
              'the resumed state differs from the saved one')
        start = [p.detach().clone() for p in model.state.params]
        zero_counts()
        resumed_losses = resumed.train()
        by_path['resume_train'] = launch_counts()
        # the epoch the resumed model's train() read: the token cache's,
        # through a fresh cache object as the resumed model's: the same
        # sticky packed capacities, so the same dropout masks
        losses = []
        cache = TokenCache.build_or_load(model.config, model.vocabs,
                                         model.reader)
        for packed in cache.iter_epoch(model.config.TRAIN_BATCH_SIZE,
                                       seed=CKPT_EPOCHS,
                                       wire_format='packed'):
            model.state, loss = model.trainer.train_step(model.state, packed)
            losses.append(float(loss))
        check(resumed.state.step == model.state.step == steps + 3,
              'resumed %d steps, continued %d' % (resumed.state.step,
                                                  model.state.step))
        r = resume_readings(resumed.state, model.state, start)
        loss_err = abs(resumed_losses[0] - statistics.mean(losses)) / abs(
            statistics.mean(losses))
        check(loss_err <= RESUME_LIMITS['loss'], 'resumed loss %.6g vs %.6g'
              % (resumed_losses[0], statistics.mean(losses)))
        for moment in ('mu', 'nu'):
            for key, value in r[moment].items():
                check(value <= RESUME_LIMITS[key], 'resumed Adam %s: %s '
                      '%.3g > %.3g' % (moment, key, value,
                                       RESUME_LIMITS[key]))
        check(r['weights'] <= RESUME_LIMITS['weights'], 'resumed weights: '
              'update ||diff||/||update|| %.3g > %.3g'
              % (r['weights'], RESUME_LIMITS['weights']))
        del resumed, model, start
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    expected = {'checkpoint_train': STEP_KERNELS,
                'reload_eval': ('ragged_fwd',),
                'resume_train': STEP_KERNELS}
    for path, kernels in expected.items():
        counts = by_path[path]
        check(all(counts[k] > 0 for k in kernels) and all(
            counts[k] == 0 for k in counts if k not in kernels),
            'launches on the %s path: %s' % (path, counts))
    print('checkpoint: java14m width and vocabulary, fused CE: train() %d '
          'epochs of 3 steps with a save and an evaluation after each, '
          '%.1f s; entire-model save %.3f GB in %.3f s (%.3f GB/s; apart: '
          'card -> host %.3f s, torch.save of the host tensors %.3f s); '
          'restore of the newest step %.3f GB in %.3f s '
          '(%.3f GB/s: torch.load from the page cache -> card); release '
          '%.3f GB in %.3f s (%.3f GB/s); params-only reload (vocab + '
          'params) %.2f s; reload evaluate() and 64 predictions equal to '
          'the model in memory bit for bit; restored state equal; release '
          'loads at 261,248 target rows; resumed epoch vs continued in '
          'memory: loss rel err %.3g, Adam %s, update ||diff||/||update|| '
          '%.3g (limits %s); launches %s [%s]'
          % (CKPT_EPOCHS, train_s, save_gb, save_s, save_gb / save_s,
             d2h_s, write_s, save_gb, restore_s, save_gb / restore_s, release_gb, release_s,
             release_gb / release_s, reload_s, loss_err,
             {m: {k: float('%.3g' % v) for k, v in r[m].items()}
              for m in ('mu', 'nu')}, r['weights'], RESUME_LIMITS, by_path,
             gpu))
    return by_path


def cli_phase(rng, gpu: str) -> dict:
    """``code2vec_tpu_torch.cli.main`` in process on the card: train with
    --fused-ce and --save (one epoch, evaluated), ``--load --test`` (the
    plain route's target rows, sliced from the fused CE's), ``--release``,
    ``--save_word2v``; full width (dims 128/128/384, 200 contexts, B 1024)
    over a 5,000 / 3,000 / 1,000-word vocabulary, so the word2vec text
    stays small. Returns the launches."""
    import torch
    from code2vec_tpu_torch import cli
    root = Path(tempfile.mkdtemp(prefix='cli_', dir=SMOKE_DIR))
    try:
        prefix = root / 'cli'
        write_dict(Path(str(prefix) + '.dict.c2v'), 5000, 3000, 1000)
        sizes = (4999, 2999, 999)
        (root / 'cli.train.c2v').write_text(
            '\n'.join(make_lines(rng, 2100, sizes, 200)) + '\n')
        test = root / 'cli.test.c2v'
        test.write_text('\n'.join(make_lines(rng, 1024, sizes, 200)) + '\n')
        save = root / 'models' / 'saved_model'
        w2v = root / 'tokens.w2v'
        quiet = ['-v', '0']
        zero_counts()
        t0 = time.perf_counter()
        trained = cli.main(['--data', str(prefix), '--test', str(test),
                            '--save', str(save), '--epochs', '1',
                            '--fused-ce'] + quiet)
        loaded = cli.main(['--load', str(save), '--test', str(test)] + quiet)
        cli.main(['--load', str(save), '--release'] + quiet)
        cli.main(['--load', str(save), '--save_word2v', str(w2v)] + quiet)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check(trained.device.type == 'cuda' and loaded.device.type == 'cuda',
              'the CLI ran off the card')
        check(trained.state.step == 3 and math.isfinite(
            trained.eval_history[-1]['loss']),
            'CLI train: %d steps, evaluation %s'
            % (trained.state.step, trained.eval_history))
        check(loaded.backend.sizes['target_vocab_size'] == 1024
              and trained.backend.sizes['target_vocab_size'] == 1024,
              'target rows %d / %d' % (trained.backend.sizes[
                  'target_vocab_size'], loaded.backend.sizes[
                  'target_vocab_size']))
        log_lines = (save.parent / 'log.txt').read_text().splitlines()
        check(len(log_lines) >= 1024, 'log.txt has %d lines' % len(log_lines))
        check((Path(str(save) + '__only-weights') / 'checkpoint.pt').is_file(),
              'no release')
        w2v_lines = w2v.read_text().splitlines()
        n_tokens = trained.vocabs.token_vocab.size
        check(w2v_lines[0] == '%d 128' % n_tokens
              and len(w2v_lines) == n_tokens + 1
              and all(math.isfinite(float(v))
                      for v in w2v_lines[1].split()[1:]),
              'word2vec export: header %r, %d lines'
              % (w2v_lines[0], len(w2v_lines)))
        expected = {'ragged_fwd': 5, 'ragged_bwd': 3, 'ce_fwd': 3,
                    'ce_bwd': 3, 'encode': 0,
                    'adam_update': 3 * PARAMS_PER_STEP, 'adam_rows': 0}
        check(counts == expected, 'CLI launches %s, expected %s'
              % (counts, expected))
        print('cli: train (3 steps, --fused-ce) + save, --load --test, '
              '--release, --save_word2v (%d tokens x 128) in process on the '
              'card, %.1f s; loss after the epoch %.4f; launches %s [%s]'
              % (n_tokens, seconds, trained.eval_history[-1]['loss'], counts,
                 gpu))
        del trained, loaded
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {name: counts[name] for name in STEP_KERNELS}


# where the host data path's phases run: the card; a rehearsal on the CPU
# sets it to 'cpu' (the kernels' plain versions, counted as launches)
DEVICE = 'cuda'
PIPELINE_LINES = 32768          # 32 steps of 1024 per epoch


def median_or_nan(values) -> float:
    return statistics.median(values) if values else math.nan


def host_pipeline_phase(model, test_path: Path, gpu: str) -> int:
    """The host data path at java14m width on the smoke's vocabulary and
    4,096-line test split: the native tokenizer built (timed, into a
    fresh path) and its arrays held equal to the Python reader's on the
    test lines; each reader's host time per batch of 1024 (read,
    tokenize, filter, pack); ``evaluate()`` with the native reader and
    the staging ring against ``READER_USE_NATIVE=False`` on the same
    weights: metrics and log.txt equal; for each, the seconds, the host
    read, the device eval step, the decode and the card's idle share of
    the call. Returns the ragged forward's launches in the native
    ``evaluate()``."""
    import contextlib
    from code2vec_tpu_torch import hostbuild
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data import native
    from code2vec_tpu_torch.data.reader import PathContextReader
    from code2vec_tpu_torch.metrics import (SubtokensEvaluationMetric,
                                            TopKAccuracyEvaluationMetric,
                                            decode_topk_batch)
    from code2vec_tpu_torch.model_api import Code2VecModel
    config = model.config
    check(config.READER_USE_NATIVE, 'the native reader is not the default')
    fresh = SMOKE_DIR / 'native_build' / 'libc2vtok.so'
    shutil.rmtree(fresh.parent, ignore_errors=True)
    t0 = time.perf_counter()
    hostbuild.build(str(fresh), native.SOURCE, native.GXX_FLAGS)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokenizer = native.NativeTokenizer(model.vocabs, config)
    upload_s = time.perf_counter() - t0
    lines = test_path.read_text().splitlines(keepends=True)
    python_config = Config(**dict(vars(config), READER_USE_NATIVE=False))
    python_reader = PathContextReader(model.vocabs, python_config)
    got = tokenizer.tokenize_lines(lines)
    want = python_reader.tokenize_lines(lines)
    for field in ('source', 'path', 'target', 'mask', 'label', 'weight'):
        check(np.array_equal(getattr(got, field), getattr(want, field)),
              'native tokenizer: %s differs from the Python reader' % field)
    print('native tokenizer: g++ build %.1f s, vocabulary upload %.2f s '
          '(%d words), %d test lines tokenized equal to the Python reader'
          % (build_s, upload_s, sum(v.size for v in (
              model.vocabs.token_vocab, model.vocabs.path_vocab,
              model.vocabs.target_vocab)), len(lines)))

    k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    oov = model.vocabs.target_vocab.special_words.OOV
    runs = {}
    python_model = Code2VecModel(python_config, device=DEVICE,
                                 params=model.backend.params)
    for name, m in (('native', model), ('python', python_model)):
        reader = PathContextReader(m.vocabs, m.config)
        list(reader.iter_epoch(evaluate=True))      # tokenizer warm
        t0 = time.perf_counter()
        batches = list(reader.iter_epoch(evaluate=True))
        read_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        arrays = m.trainer.place(batches[0])
        step_ms = (cuda_ms(lambda: m.trainer.eval_step_placed(arrays))
                   if DEVICE == 'cuda' else math.nan)
        out = m.trainer.eval_step_placed(arrays)
        t0 = time.perf_counter()
        fetched = {key: value.cpu().numpy() for key, value in out.items()}
        decoded = decode_topk_batch(fetched['topk_indices'],
                                    m._target_index_to_word,
                                    batches[0].label_strings,
                                    batches[0].weight)
        TopKAccuracyEvaluationMetric(k, oov).update_batch(decoded)
        SubtokensEvaluationMetric(oov).update_batch(decoded)
        with open(SMOKE_DIR / 'log_breakdown.txt', 'w') as f:
            m._log_predictions_during_evaluation(decoded, f)
        decode_ms = (time.perf_counter() - t0) * 1e3
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.chdir(SMOKE_DIR):
            results = m.evaluate()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check(counts == {n: len(batches) * int(n == 'ragged_fwd')
                         for n in counts},
              'evaluate() (%s reader) in %d batches launched %s'
              % (name, len(batches), counts))
        log = (SMOKE_DIR / 'log.txt').read_text()
        idle = 1.0 - len(batches) * step_ms / (seconds * 1e3)
        runs[name] = (results, log, counts['ragged_fwd'])
        print('evaluate (%s reader, staging ring depth %d): %d batches in '
              '%.3f s (host clock); per batch: host read+tokenize+filter+'
              'pack %.1f ms, device eval step %.4f ms (graph replay), host '
              'fetch+decode+metrics+log %.1f ms; card idle ~%.1f%% of the '
              'call (1 - batches x step / seconds) [%s]'
              % (name, m.config.DEVICE_PREFETCH_BATCHES, len(batches),
                 seconds, read_ms, step_ms, decode_ms, 100 * idle, gpu))
    staging_check(model, list(PathContextReader(
        model.vocabs, config).iter_epoch(evaluate=True)), gpu)
    (got, got_log, launches), (want, want_log, _) = (runs['native'],
                                                    runs['python'])
    check(np.array_equal(got.topk_acc, want.topk_acc)
          and (got.subtoken_precision, got.subtoken_recall,
               got.subtoken_f1) == (want.subtoken_precision,
                                    want.subtoken_recall, want.subtoken_f1)
          and got.loss == want.loss and got_log == want_log,
          'evaluate() differs across readers: %s vs %s' % (got, want))
    print('evaluate: native and Python readers give equal metrics, loss and '
          'log.txt (%d lines)' % got_log.count('\n'))
    del python_model
    return launches


STAGING_DEPTHS = (0, 2, 4)


def staging_check(model, batches, gpu: str) -> None:
    """``Trainer.stage_batches`` at depths 0, 2 and 4 over the same host
    batches (each given four times, so the pinned buffers are refilled
    while earlier copies and steps are in flight): every batch as the
    step's stream reads it equals its host arrays (sums taken on that
    stream), and the eval step's outputs are equal bit for bit at every
    depth."""
    import torch
    trainer = model.trainer
    stream = batches * 4
    seen = {}
    for depth in STAGING_DEPTHS:
        sums, outs = [], []
        for arrays, _batch in trainer.stage_batches(iter(stream),
                                                    depth=depth):
            sums.append(torch.stack([a.double().sum() for a in arrays]))
            out = trainer.eval_step_placed(arrays)
            outs.append(torch.cat([out['topk_indices'].double().ravel(),
                                   out['loss_sum'].double().reshape(1)]))
        seen[depth] = (torch.stack(sums).cpu().numpy(),
                       torch.stack(outs).cpu().numpy())
    want_sums = np.array([[float(np.asarray(a, np.float64).sum())
                           for a in b.device_arrays()] for b in stream])
    for depth, (sums, outs) in seen.items():
        check(np.array_equal(sums, want_sums),
              'staging depth %d: a batch as the step read it differs from '
              'its host arrays' % depth)
        check(np.array_equal(outs, seen[0][1]),
              'staging depth %d: eval outputs differ from depth 0' % depth)
    pinned = trainer._pinned.buffers
    check(pinned and all(b.is_pinned() for b in pinned) or DEVICE != 'cuda',
          'staged host buffers are not pinned')
    print('staging ring: %d batches at depths %s, each as the step read it '
          'equal to its host arrays, eval outputs equal across depths; %d '
          'pinned host buffers [%s]' % (len(stream), STAGING_DEPTHS,
                                        len(pinned), gpu))


def write_pipeline_split(prefix: Path, vocab_sizes, rng,
                         lines: int = 0) -> None:
    """``prefix.train.c2v`` of ``lines`` (PIPELINE_LINES by default)
    synthetic java14m lines, beside the java14m vocabulary (linked)."""
    lines = lines or PIPELINE_LINES
    java14m = SMOKE_DIR / 'java14m.dict.c2v'
    link = Path(str(prefix) + '.dict.c2v')
    if not link.exists():
        link.symlink_to(java14m.name)
    with open(str(prefix) + '.train.c2v', 'w') as f:
        for start in range(0, lines, 4096):
            n = min(4096, lines - start)
            f.write('\n'.join(make_lines(rng, n, vocab_sizes, 200)) + '\n')


def train_epochs_report(name: str, timings, step_ms: float, gpu: str
                        ) -> None:
    for t in timings:
        wall_ms = t['seconds'] * 1e3
        intervals = t['interval_ms']
        print('train (%s) epoch %d: %d steps in %.3f s; step interval '
              'median %.3f ms, mean %.3f ms (CUDA events between steps\' '
              'ends); wait for the next staged batch: first %.1f ms, '
              'median %.3f ms, total %.1f ms (host clock); a step on one '
              'repeated batch %.3f ms (CUDA events, steps back to back); '
              'card idle ~%.1f%% of the epoch (1 - steps x that step / '
              'wall) [%s]'
              % (name, t['epoch'] + 1, t['steps'], t['seconds'],
                 median_or_nan(intervals),
                 statistics.mean(intervals) if intervals else math.nan,
                 t['wait_s'][0] * 1e3, median_or_nan(t['wait_s']) * 1e3,
                 sum(t['wait_s']) * 1e3, step_ms,
                 100 * (1 - t['steps'] * step_ms / wall_ms), gpu))


def repeated_step_ms(model, batch) -> float:
    """Device ms of a train step on one staged batch, steps queued back to
    back (CUDA events between their ends, median of 8; nan off the
    card). The model's state moves on with the steps."""
    import torch
    arrays = model.trainer.place(batch)
    state = model.state
    ends = []
    for _ in range(12):
        state, loss = model.trainer.train_step_placed(state, arrays)
        if DEVICE == 'cuda':
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
    float(loss)
    model.state = state
    return median_or_nan([a.elapsed_time(b) for a, b in
                          zip(ends[3:], ends[4:])])


def train_pipeline_phase(vocab_sizes, rng, gpu: str) -> dict:
    """``train()`` fed by the host data path at java14m width and
    vocabulary (fused CE, bf16, keep 0.75) over a synthetic split of
    PIPELINE_LINES lines: two epochs from the token cache (built before
    the first), then one with TRAIN_DATA_CACHE=False (the native
    tokenizer behind the prefetch thread). Prints the cache build's
    seconds and bytes, each epoch's step interval and wait for the next
    staged batch, beside the device time of a step on one repeated batch
    (steps queued back to back); checks each step launched the four training kernels once, the
    losses are finite and the staging ring's host buffers are pinned.
    Returns the launches per path."""
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.cache import TokenCache
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = SMOKE_DIR / 'pipeline'
    t0 = time.perf_counter()
    write_pipeline_split(prefix, vocab_sizes, rng)
    shutil.rmtree(str(prefix) + '.train.c2v.tokcache', ignore_errors=True)
    print('train pipeline: wrote %d lines (%.1f MB) in %.1f s'
          % (PIPELINE_LINES, Path(str(prefix) + '.train.c2v').stat().st_size
             / 1e6, time.perf_counter() - t0))
    launches = {}
    steps = PIPELINE_LINES // 1024
    for name, cache, epochs in (('train_cache', True, 2),
                                ('train_native', False, 1)):
        config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                        USE_PALLAS_FUSED_CE=True, NUM_TRAIN_EPOCHS=epochs,
                        TRAIN_DATA_CACHE=cache)
        model = Code2VecModel(config, device=DEVICE, seed=7)
        # the tokenizer (built in train() for the cache, else on the
        # prefetch thread at the first batch) loaded before the epochs
        t0 = time.perf_counter()
        model.reader.native_tokenizer()
        print('train (%s): native tokenizer loaded and its vocabulary '
              'uploaded in %.2f s, before train()' % (
                  name, time.perf_counter() - t0))
        timings = []
        zero_counts()
        losses = model.train(timings=timings)
        counts = train_counts()
        check(model.state.step == epochs * steps
              and all(math.isfinite(x) for x in losses),
              '%s: %d steps, losses %s' % (name, model.state.step, losses))
        check_step_launches(counts, model.state.step, name)
        pinned = model.trainer._pinned.buffers
        check(DEVICE != 'cuda' or (pinned and all(b.is_pinned()
                                                   for b in pinned)),
              '%s: staged host buffers not pinned' % name)
        launches[name] = counts
        # one batch of the split, staged once, stepped repeatedly
        if cache:
            cache_dir = str(prefix) + '.train.c2v.tokcache'
            print('train (%s): token cache built in %.2f s, %d bytes '
                  '(%.2f MB) for %d rows; %d pinned host buffers'
                  % (name, timings[0]['cache_build_s'],
                     timings[0]['cache_bytes'],
                     timings[0]['cache_bytes'] / 1e6,
                     TokenCache(cache_dir, config, model.vocabs).num_rows,
                     len(pinned)))
            batch = next(TokenCache(cache_dir, config, model.vocabs)
                         .iter_epoch(1024, seed=9, wire_format='packed'))
        else:
            batch = next(model.reader.iter_epoch(seed=9))
        step_ms = repeated_step_ms(model, batch)
        train_epochs_report(name, timings, step_ms, gpu)
        print('train (%s): mean losses %s; launches %s (each kernel once a '
              'step) [%s]' % (name, ['%.4f' % x for x in losses], counts,
                              gpu))
        del model
        if DEVICE == 'cuda':
            torch.cuda.empty_cache()
    return launches


DENSE_ROUTES = (('train_planes', ['--wire-format', 'planes'], 2),
                ('train_unpack', ['--no-ragged-fusion'], 1))
# the CE kernels' device work in a profiled step, by kernel name (``\b``:
# not inside another name, such as a device_reduce)
CE_FWD_KERNELS = r'\bce_(fwd|merge)_'
CE_BWD_KERNELS = r'\bce_(bwd|reduce)_'




def profiled_ce_ms(model, batch, gpu: str, steps: int = 4) -> dict:
    """The CE kernels' device ms per step as the dense route launches them
    (torch.profiler over ``steps`` train steps on one batch), by pass;
    None where the trace holds no device time. Prints the step's eight
    largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    arrays = model.trainer.place(batch)
    state, _loss = model.trainer.train_step_placed(model.state, arrays)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _loss = model.trainer.train_step_placed(state, arrays)
        torch.cuda.synchronize()
    model.state = state
    out = {'fwd': 0.0, 'bwd': 0.0}
    by_kernel = []
    for event in prof.key_averages():
        total_us = getattr(event, 'device_time_total', None)
        if total_us is None:
            total_us = getattr(event, 'cuda_time_total', 0.0)
        if total_us:
            by_kernel.append((total_us / steps / 1e3, event.key[:60]))
        for part, pattern in (('fwd', CE_FWD_KERNELS),
                              ('bwd', CE_BWD_KERNELS)):
            if re.search(pattern, event.key):
                out[part] += total_us / steps / 1e3
    by_kernel.sort(reverse=True)
    print('train (train_planes) step by kernel (torch.profiler, device ms '
          'per step, the 8 largest of %.3f): %s [%s]'
          % (sum(ms for ms, _ in by_kernel),
             '; '.join('%s %.3f' % (name, ms) for ms, name in by_kernel[:8]),
             gpu))
    return {part: (ms if ms > 0 else None) for part, ms in out.items()}


def plane_step_reference(model) -> dict:
    """One plane-wire step at keep 1.0 on the card through the CE kernels,
    against the same step with the CE's plain versions: the loss's
    relative difference and each gradient's scaled error (the target
    table's label rows and other rows apart)."""
    import torch
    from code2vec_tpu_torch.data.cache import TokenCache
    from code2vec_tpu_torch.models import functional
    from code2vec_tpu_torch.models.functional import Code2VecParams
    from code2vec_tpu_torch.ops import ce
    backend = model.backend
    cache = model.config.train_data_path + '.tokcache'
    batch = next(TokenCache(cache, model.config, model.vocabs).iter_epoch(
        1024, seed=11, wire_format='planes'))
    arrays = model.trainer.place(batch)

    def step():
        params = Code2VecParams(*[p.detach().clone().requires_grad_()
                                  for p in backend.params])
        loss, _aux = functional.loss_and_aux(
            params, *arrays, dtype=backend.dtype, keep_rate=1.0,
            num_valid_targets=backend.num_valid_targets, use_fused_ce=True)
        loss.backward()
        return float(loss.detach()), [p.grad for p in params]

    loss, grads = step()
    kernels = (ce._lse_pick_kernel, ce._ce_grads_kernel)
    ce._lse_pick_kernel = ce._lse_pick_plain
    ce._ce_grads_kernel = ce._ce_grads_plain
    try:
        plain_loss, plain_grads = step()
    finally:
        ce._lse_pick_kernel, ce._ce_grads_kernel = kernels
    label = arrays[4][arrays[5] > 0].long()
    is_label = torch.zeros(grads[2].shape[0], dtype=torch.bool,
                           device=label.device)
    is_label[label] = True
    errs = {name: scaled_err([g], [w]) for name, g, w in zip(
        Code2VecParams._fields, grads, plain_grads)
        if name != 'target_embedding'}
    errs['target label rows'] = scaled_err([grads[2][is_label]],
                                           [plain_grads[2][is_label]])
    errs['target other rows'] = scaled_err([grads[2][~is_label]],
                                           [plain_grads[2][~is_label]])
    errs['loss'] = abs(loss - plain_loss) / abs(plain_loss)
    return errs


def snapshot_and_rewind_s(model) -> tuple:
    """A step snapshot of the model's java14m state (seconds, GB) and the
    divergence guard's rewind from it (restore under the step ceiling and
    the state made on the card, seconds), in a directory under
    build/smoke/ that it removes."""
    import torch
    root = Path(tempfile.mkdtemp(prefix='snapshot_', dir=SMOKE_DIR))
    try:
        path = str(root / 'm' / 'saved_model')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.save(path, epoch=0, snapshot=True)
        save_s = time.perf_counter() - t0
        store = model._store_for(path)
        step = int(model.state.step)
        files = Path(store.snapshot_dir) / str(step)
        gb = sum(f.stat().st_size for f in files.iterdir()) / 1e9
        check(store.steps() == [] and store.has_step(step),
              'the snapshot did not land in the snapshot directory')
        t0 = time.perf_counter()
        restored = store.restore_training(max_step=step)
        state = model.trainer.state_from_restored(
            restored.params, restored.opt_state, restored.step)
        torch.cuda.synchronize()
        rewind_s = time.perf_counter() - t0
        check(state.step == step and restored.epoch == 0,
              'rewound to step %d' % state.step)
        model.state = state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return save_s, gb, rewind_s


def dense_route_phase(gpu: str) -> dict:
    """``Code2VecModel.train()`` on the dense routes at java14m width and
    vocabulary (fused CE, bf16, keep 0.75) over the train pipeline's
    split and token cache: the plane wire (``--wire-format planes``) two
    epochs, the packed wire unpacked on the card (``--no-ragged-fusion``)
    one. Each step launches ``ce_fwd`` and ``ce_bwd`` once and Adam once a
    parameter, no ragged and no encode kernel; the plane wire's loss
    falls. Prints each route's step interval (CUDA events) and, on one
    repeated batch, its device step beside the packed ragged route's, the
    CE kernels' device ms per step as the plane step launches them
    (torch.profiler), one plane step at keep 1.0 against the same step
    with the CE's plain versions, and a java14m step snapshot's save and
    rewind seconds. Returns the launches per path."""
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.cache import TokenCache
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = SMOKE_DIR / 'pipeline'
    steps_per_epoch = PIPELINE_LINES // 1024
    launches, step_ms = {}, {}
    for name, flags, epochs in DENSE_ROUTES:
        config = Config().load_from_args(
            ['--data', str(prefix), '--fused-ce', '--epochs', str(epochs),
             '-v', '0'] + flags)
        model = Code2VecModel(config, device=DEVICE, seed=7)
        timings = []
        zero_counts()
        losses = model.train(timings=timings)
        counts = launch_counts()
        steps = model.state.step
        check(steps == epochs * steps_per_epoch
              and all(math.isfinite(x) for x in losses),
              '%s: %d steps, losses %s' % (name, steps, losses))
        expected = {'ragged_fwd': 0, 'ragged_bwd': 0, 'ce_fwd': steps,
                    'ce_bwd': steps, 'encode': 0,
                    'adam_update': PARAMS_PER_STEP * steps, 'adam_rows': 0}
        check(counts == expected, '%s: launches %s, expected %s'
              % (name, counts, expected))
        if epochs > 1:
            check(losses[-1] < losses[0], '%s: the loss did not fall: %s'
                  % (name, losses))
        launches[name] = {k: counts[k] for k in STEP_KERNELS}
        wire = 'planes' if config.BATCH_WIRE_FORMAT == 'planes' else 'packed'
        batch = next(TokenCache(str(prefix) + '.train.c2v.tokcache', config,
                                model.vocabs).iter_epoch(
            1024, seed=9, wire_format=wire))
        step_ms[name] = repeated_step_ms(model, batch)
        train_epochs_report(name, timings, step_ms[name], gpu)
        print('train (%s): %d steps through Code2VecModel.train() (%s), '
              'mean losses %s; launches %s (ce_fwd and ce_bwd once a step, '
              'no ragged or encode kernel) [%s]'
              % (name, steps, ' '.join(flags), ['%.4f' % x for x in losses],
                 counts, gpu))
        if name == 'train_planes':
            ce_ms = profiled_ce_ms(model, batch, gpu)
            errs = plane_step_reference(model)
            limit = TRAIN_REF_LIMITS['bfloat16']
            check(errs['loss'] <= limit['loss']
                  and all(v <= limit['scaled'] for k, v in errs.items()
                          if k != 'loss'),
                  'plane step: CE kernels against their plain versions %s '
                  '(limits loss %.3g, scaled %.3g)'
                  % (errs, limit['loss'], limit['scaled']))
            shown = {part: 'not measured' if ms is None else '%.4f ms' % ms
                     for part, ms in ce_ms.items()}
            print('train (train_planes): CE kernels as the plane step '
                  'launches them (torch.profiler, per step): ce_fwd %s, '
                  'ce_bwd %s; one plane step at keep 1.0, CE kernels '
                  'against the CE\'s plain versions: %s (limits: loss %.3g, '
                  'each gradient part %.3g of its scale) [%s]'
                  % (shown['fwd'], shown['bwd'],
                     {k: float('%.3g' % v) for k, v in errs.items()},
                     limit['loss'], limit['scaled'], gpu))
            save_s, gb, rewind_s = snapshot_and_rewind_s(model)
            print('step snapshot (java14m state, %.3f GB): save %.3f s '
                  '(%.2f GB/s); rewind (restore under the step ceiling, '
                  'state on the card) %.3f s [%s]'
                  % (gb, save_s, gb / save_s, rewind_s, gpu))
        del model
        torch.cuda.empty_cache()
    # the packed wire's ragged route on the same rows, for comparison
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    USE_PALLAS_FUSED_CE=True)
    model = Code2VecModel(config, device=DEVICE, seed=7)
    model.state = model.trainer.state_from_params()
    batch = next(TokenCache(str(prefix) + '.train.c2v.tokcache', config,
                            model.vocabs).iter_epoch(1024, seed=9,
                                                     wire_format='packed'))
    step_ms['train_packed'] = repeated_step_ms(model, batch)
    del model
    torch.cuda.empty_cache()
    print('train step on one repeated batch (device ms, CUDA events): plane '
          'wire %.3f, packed unpacked %.3f, packed ragged %.3f [%s]'
          % (step_ms['train_planes'], step_ms['train_unpack'],
             step_ms['train_packed'], gpu))
    return launches


# the telemetry phase's split: one epoch of 128 steps, so the run's fixed
# costs outside its steps (the final flush, the epoch's loss mean) stay a
# small share of its wall; the step its profiler capture starts at, and
# the kernels a captured java14m train step must show, by name
TELEMETRY_LINES = 4 * PIPELINE_LINES
TELEMETRY_TRACE_STEP = 8
TRACED_TRAIN_KERNELS = ('ragged_fwd', 'ragged_bwd', 'ce_fwd', 'ce_bwd',
                        'adam_update')
# MFU of a java14m train() window on the card (the peak: NVIDIA's dense
# bf16 figure); the analytic count predicts ~0.08
MFU_RANGE = (0.03, 0.30)
JAVA14M_STATE_BYTES = 3.072e9     # fp32 masters + bf16 Adam moments


def trace_kernel_counts(path: Path) -> dict:
    """Kernel events of a Chrome trace whose name holds each of
    TRACED_TRAIN_KERNELS."""
    events = json.loads(path.read_text())['traceEvents']
    kernels = [e.get('name', '') for e in events if e.get('cat') == 'kernel']
    return {name: sum(name in k for k in kernels)
            for name in TRACED_TRAIN_KERNELS}


def telemetry_phase(vocab_sizes, rng, gpu: str) -> dict:
    """``cli.main`` trains at java14m width and vocabulary (fused CE, bf16,
    keep 0.75) one epoch over a split of TELEMETRY_LINES synthetic lines
    from its token cache with ``--telemetry --trace-at-step
    TELEMETRY_TRACE_STEP --memory-report`` into build/smoke/telemetry/:
    the peak is the H100 row; every window's ``train/mfu`` is finite and
    those after the first (which holds the first step and the capture)
    within MFU_RANGE;
    ``scripts/goodput_report.py --json`` (a subprocess) reads one run span
    with less than 2% of its wall unattributed; the capture under
    ``traces/step<K>/`` names the ragged forward and backward, ``ce_fwd``,
    ``ce_bwd`` and ``adam_update`` kernels; at a step boundary the
    ledger's params + opt_state are the state's bytes, within 1% of
    3.072 GB, and the unattributed bytes under 10% of the card's live
    bytes. Then the budget (a HBM_BUDGET_BYTES one byte under the state
    refuses the model before anything is allocated) and an OOM (a real
    ``torch.cuda.OutOfMemoryError`` inside ``Trainer.fit`` writes
    ``oom_ledger.json`` and is raised again). Returns the launches."""
    import gc
    import subprocess
    import torch
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.telemetry import goodput
    from code2vec_tpu_torch.telemetry import memory as memory_lib
    from code2vec_tpu_torch.training.trainer import state_bytes
    prefix = SMOKE_DIR / 'telemetry_split'
    tele = SMOKE_DIR / 'telemetry'
    shutil.rmtree(tele, ignore_errors=True)
    shutil.rmtree(str(prefix) + '.train.c2v.tokcache', ignore_errors=True)
    write_pipeline_split(prefix, vocab_sizes, rng, lines=TELEMETRY_LINES)
    steps = TELEMETRY_LINES // 1024
    k = TELEMETRY_TRACE_STEP
    # earlier phases' models gone from the ledger (their finalizers run
    # when they are collected)
    gc.collect()
    zero_counts()
    t0 = time.perf_counter()
    model = cli.main(['--data', str(prefix), '--fused-ce', '--epochs', '1',
                      '-v', '0', '--telemetry', '--telemetry-dir', str(tele),
                      '--trace-at-step', str(k), '--memory-report',
                      '--device', DEVICE])
    wall = time.perf_counter() - t0
    counts = train_counts()
    check(model.state.step == steps, 'telemetry: %d steps' % model.state.step)
    check_step_launches(counts, steps, 'telemetry')
    # the peak: the H100 row of the table, by the card's name
    name = torch.cuda.get_device_name(0)
    peak = model.trainer._telemetry.peak_flops
    row = 'NVIDIA H100 PCIe' if 'pcie' in name.lower() else 'NVIDIA H100'
    check(name.startswith('NVIDIA H100')
          and peak == goodput.KNOWN_DEVICE_PEAK_FLOPS[row],
          'telemetry: peak %g for %r' % (peak, name))
    by_tag = {}
    for line in open(tele / 'metrics.jsonl'):
        record = json.loads(line)
        by_tag.setdefault(record['tag'], {})[record['step']] = record
    windows = [json.loads(l) for l in open(tele / 'intervals.jsonl')]
    windows = [w for w in windows if w['kind'] == 'window' and w['steps']]
    mfus = [w['mfu'] for w in windows]
    check(len(mfus) > 1
          and all(m is not None and math.isfinite(m) for m in mfus)
          and all(MFU_RANGE[0] <= m <= MFU_RANGE[1] for m in mfus[1:]),
          'telemetry: train/mfu by window %s (range %s)' % (mfus, MFU_RANGE))
    flops = by_tag['train/step_flops'][steps]['value']
    print('telemetry: cli.main train() %d steps in %.1f s; peak %.4g FLOP/s '
          '(%s row); a step at packed capacity %d: %.4g FLOP, %.4g bytes '
          '(analytic); MFU by '
          'window %s (steps %s); examples/s %.1f; step/dispatch_ms p50 '
          '%.3f, step/batch_wait_ms p50 %.3f, step/sync_ms p50 %.3f, '
          'step/h2d_ms p50 %.3f [%s]'
          % (steps, wall, peak, row,
             by_tag['jit/packed_capacity'][steps]['value'], flops,
             by_tag['train/step_bytes'][steps]['value'],
             ['%.4f' % m for m in mfus], [w['steps'] for w in windows],
             by_tag['train/examples_per_sec'][steps]['value'],
             by_tag['step/dispatch_ms'][steps]['p50_ms'],
             by_tag['step/batch_wait_ms'][steps]['p50_ms'],
             by_tag['step/sync_ms'][steps]['p50_ms'],
             by_tag['step/h2d_ms'][steps]['p50_ms'], gpu))
    # the goodput report, as a user runs it
    report = subprocess.run(
        [sys.executable, str(ROOT / 'scripts' / 'goodput_report.py'),
         str(tele), '--json'], capture_output=True, text=True, timeout=120,
        check=True)
    spans = report.stdout.splitlines()
    check(len(spans) == 1, 'goodput report: %d run spans' % len(spans))
    summary = json.loads(spans[0])
    share = summary['badput_s']['unattributed'] / summary['wall_s']
    print('telemetry: goodput report (scripts/goodput_report.py --json): '
          'wall %.3f s, productive %.3f s (goodput %.4f), badput %s, '
          'unattributed %.3f%% [%s]'
          % (summary['wall_s'], summary['productive_s'],
             summary['goodput_fraction'],
             {k2: round(v, 4) for k2, v in summary['badput_s'].items() if v},
             100 * share, gpu))
    check(share < 0.02, 'goodput report: %.2f%% unattributed' % (100 * share))
    # the profiler capture names the step's kernels
    kernels = trace_kernel_counts(tele / 'traces' / ('step%d' % k)
                                  / 'trace.json')
    check(all(n > 0 for n in kernels.values()),
          'telemetry: kernels in the step %d capture %s' % (k, kernels))
    print('telemetry: torch.profiler capture of steps %d-%d '
          '(traces/step%d/trace.json): kernel events by name %s [%s]'
          % (k, k + model.config.TELEMETRY_TRACE_NUM_STEPS - 1, k, kernels,
             gpu))
    # the ledger at a step boundary (the mid-run flush)
    boundary = min(by_tag['mem/backend_live_bytes'])
    params = by_tag['mem/params_bytes'][boundary]['value']
    opt = by_tag['mem/opt_state_bytes'][boundary]['value']
    live = by_tag['mem/backend_live_bytes'][boundary]['value']
    unattributed = by_tag['mem/unattributed_bytes'][boundary]['value']
    exact = sum(t.numel() * t.element_size() for t in model.state.params) + \
        memory_lib.tree_nbytes(model.state.opt_state)
    check(params + opt == exact
          and abs(exact / JAVA14M_STATE_BYTES - 1) < 0.01
          and 0 <= unattributed < 0.1 * live,
          'telemetry: ledger at step %d: params %d + opt_state %d (state '
          '%d), unattributed %d of live %d'
          % (boundary, params, opt, exact, unattributed, live))
    snap = json.load(open(tele / 'memory_report.json'))
    print('telemetry: memory ledger at step %d: params %d + opt_state %d = '
          '%d bytes (%.4f of 3.072 GB), staging %d, card live %d, '
          'unattributed %d (%.2f%%); at the end (memory_report.json): live '
          '%d, reserved %d, unattributed %d [%s]'
          % (boundary, params, opt, params + opt,
             (params + opt) / JAVA14M_STATE_BYTES,
             by_tag['mem/staging_bytes'][boundary]['value'], live,
             unattributed, 100 * unattributed / live,
             snap['backend']['live_bytes'], snap['backend']['reserved_bytes'],
             snap['unattributed_bytes'], gpu))
    # an OOM inside a guarded site: dumped, then raised again
    def oom_batches(_epoch):
        total = torch.cuda.mem_get_info()[1]
        yield torch.empty(2 * total, dtype=torch.uint8, device=DEVICE)

    raised = False
    try:
        model.trainer.fit(model.state, oom_batches)
    except torch.cuda.OutOfMemoryError:
        raised = True
    dump = tele / 'oom_ledger.json'
    check(raised and dump.is_file() and json.load(open(dump))[
        'reason'].startswith('oom: trainer.fit:'),
          'telemetry: an OOM in Trainer.fit raised %s, dump %s'
          % (raised, dump.is_file()))
    need = state_bytes(model.config, model.backend.param_shapes(),
                       with_moments=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # the budget: refused before anything is allocated
    before = torch.cuda.memory_allocated()
    refused = None
    try:
        Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                             USE_PALLAS_FUSED_CE=True,
                             HBM_BUDGET_BYTES=need - 1,
                             TELEMETRY_DIR=str(tele)), device=DEVICE)
    except memory_lib.MemoryBudgetExceeded as exc:
        refused = str(exc)
    finally:
        memory_lib.configure(budget_bytes=0)
    check(refused is not None and torch.cuda.memory_allocated() == before,
          'telemetry: a budget of %d under a state of %d: %s, %d bytes '
          'allocated' % (need - 1, need, refused,
                         torch.cuda.memory_allocated() - before))
    print('telemetry: OOM in Trainer.fit -> oom_ledger.json, raised again; '
          'HBM_BUDGET_BYTES %d (the state %d - 1) refused the model with '
          '%d bytes allocated [%s]'
          % (need - 1, need, torch.cuda.memory_allocated() - before, gpu))
    return {'telemetry': counts}


def telemetry_phase_child() -> int:
    """``chip_smoke.py telemetry-phase``: ``telemetry_phase`` in a process
    of its own, where nothing of the earlier phases holds card memory (the
    ledger's reconciliation reads every allocation of the process). The
    kernels load from build/kernels/ (built by the parent); the last line
    printed is the phase's launch counts."""
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.ops import _build
    from code2vec_tpu_torch.vocab import Code2VecVocabs
    if not torch.cuda.is_available():
        return 1
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    for name in _build.SOURCES:
        _build.load(name)
    vocabs = Code2VecVocabs(Config(
        TRAIN_DATA_PATH_PREFIX=str(SMOKE_DIR / 'java14m')))
    vocab_sizes = tuple(v.size - 1 for v in (
        vocabs.token_vocab, vocabs.path_vocab, vocabs.target_vocab))
    del vocabs
    counts = telemetry_phase(vocab_sizes, np.random.default_rng(11), gpu)
    print(json.dumps(counts))
    return 0


def run_telemetry_phase(gpu: str) -> dict:
    """``telemetry_phase`` through ``telemetry_phase_child`` in a
    subprocess: its lines printed here, its launch counts returned."""
    import subprocess
    proc = subprocess.run([sys.executable, str(ROOT / 'chip_smoke.py'),
                           'telemetry-phase'], capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.splitlines()
    print('\n'.join(line for line in lines[:-1]
                    if line.startswith('telemetry')))
    check(proc.returncode == 0 and lines,
          'telemetry phase (subprocess) exit %d: %s'
          % (proc.returncode, (proc.stdout + proc.stderr)[-3000:]))
    print('telemetry: the phase ran in a process of its own [%s]' % gpu)
    return json.loads(lines[-1])


def engine_telemetry_phase(model, rng, gpu: str) -> None:
    """The engine with telemetry on and per-request tracing at rate 1.0:
    a topk ladder on one slot, 40 requests. Every request's trace lands
    in spans.jsonl with its device_execute span; no capture counts as a
    compile after warm-up (``jit/compiles_total``); the ledger's
    executables bytes are the graph pool's (``pool_bytes()``)."""
    import torch
    from code2vec_tpu_torch.telemetry import core, tracing
    out = SMOKE_DIR / 'engine_telemetry'
    shutil.rmtree(out, ignore_errors=True)
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    pool = make_lines(rng, 1024, sizes, model.config.MAX_CONTEXTS)
    requests = [pool[start:start + int(n)] for start, n in
                zip(rng.integers(0, 960, 40), rng.integers(1, 65, 40))]
    core.reset()
    core.enable()
    try:
        tracer = tracing.Tracer(str(out), sample_rate=1.0)
        engine = model.serving_engine(tiers=('topk',), max_delay_ms=1.0,
                                      tracer=tracer, param_source=None)
        try:
            reg = core.registry()
            warm = reg.counter('jit/compiles_total').value
            pool = engine.ladder.pool_bytes()
            executables = reg.gauge('mem/executables_bytes').value
            for lines in requests:
                engine.predict(lines, tier='topk', timeout=300)
            after = reg.counter('jit/compiles_total').value
            stats = engine.stats()
        finally:
            engine.close()
        tracer.close()
    finally:
        core.reset()
        core.disable()
        torch.cuda.empty_cache()
    check(warm >= engine.warm_captures and after == warm,
          'engine telemetry: %d compiles at warm-up (%d captures), %d after'
          % (warm, engine.warm_captures, after))
    check(pool is not None and executables == pool,
          'engine telemetry: mem/executables_bytes %s, pool_bytes() %s'
          % (executables, pool))
    traces = {}
    for line in open(out / 'spans.jsonl'):
        record = json.loads(line)
        traces.setdefault(record['trace'], []).append(record)
    device_ms = sorted(r['dur_ms'] for spans in traces.values()
                       for r in spans if r['name'] == 'serving.device_execute')
    check(len(traces) == len(requests) == stats['requests_total']
          and len(device_ms) >= len(requests),
          'engine telemetry: %d traces, %d device_execute spans for %d '
          'requests' % (len(traces), len(device_ms), len(requests)))
    print('engine telemetry: %d graphs captured = %d compiles at warm-up, '
          '%d after; mem/executables_bytes %d = pool_bytes(); %d requests, '
          '%d traces in spans.jsonl, serving.device_execute p50 %.3f ms '
          '(host clock, dispatch return to outputs ready) [%s]'
          % (engine.warm_captures, warm, after - warm, executables,
             len(requests), len(traces), device_ms[len(device_ms) // 2],
             gpu))


DRILL_LINES = 4096              # 4 steps of 1024 an epoch


def drill_model(prefix: Path, root: Path, load: bool = False, **knobs):
    """A model of the drills' small vocabulary at full width, saving (or
    loading) under ``root``."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    save = str(root / 'm' / 'saved_model')
    knobs = dict(dict(TRAIN_DATA_PATH_PREFIX=str(prefix),
                      USE_PALLAS_FUSED_CE=True, SAVE_EVERY_EPOCHS=1000,
                      TELEMETRY_DIR=str(root / 'tele'), FAULT_INJECT=''),
                 **knobs)
    knobs['MODEL_LOAD_PATH' if load else 'MODEL_SAVE_PATH'] = save
    return Code2VecModel(Config(**knobs), device=DEVICE, seed=9)


def drill_counts(steps: int, what: str) -> dict:
    counts = train_counts()
    check_step_launches(counts, steps, what)
    return counts


def resilience_phase(rng, gpu: str) -> dict:
    """The training resilience drills on the card, on the packed wire's
    kernels, at full width over a 5,000 / 3,000 / 1,000-word vocabulary
    and a 4,096-line split (4 steps an epoch), each under a directory of
    build/smoke/ that it removes: ``nan_loss`` with step snapshots (one
    rewind, finite losses after), ``sigterm`` (a snapshot and
    PREEMPTED.json, a resume that goes on from its step, metrics.jsonl
    under -tb with train/loss on a monotonic step axis),
    ``corrupt_snapshot`` (the restore falls back a step and quarantines
    the corrupt one), and ``hang_input`` under ``--watchdog-secs`` in a
    subprocess of the CLI, which ends by SIGABRT with watchdog_stacks.txt
    naming the hung frame. Returns the drills' launches."""
    import signal
    import subprocess
    import torch
    prefix = SMOKE_DIR / 'drills'
    write_dict(Path(str(prefix) + '.dict.c2v'), 5000, 3000, 1000)
    Path(str(prefix) + '.train.c2v').write_text('\n'.join(make_lines(
        rng, DRILL_LINES, (4999, 2999, 999), 200)) + '\n')
    total = {name: 0 for name in STEP_KERNELS}

    def add(counts):
        for name in STEP_KERNELS:
            total[name] += counts[name]

    roots = []

    def new_root(name):
        roots.append(Path(tempfile.mkdtemp(prefix=name + '_',
                                           dir=SMOKE_DIR)))
        return roots[-1]
    try:
        # nan_loss: the window of batches 4-5, synced at 6, rewinds to the
        # step-4 snapshot; 12 batches end at step 10
        root = new_root('nan')
        model = drill_model(prefix, root, NUM_TRAIN_EPOCHS=3,
                            SAVE_EVERY_N_STEPS=2,
                            NUM_BATCHES_TO_LOG_PROGRESS=2,
                            FAULT_INJECT='nan_loss@step=5')
        zero_counts()
        t0 = time.perf_counter()
        losses = model.train()
        nan_s = time.perf_counter() - t0
        add(drill_counts(12, 'nan_loss drill'))
        dump = json.loads((root / 'tele' / 'divergence_step6.json')
                          .read_text())
        check(model.state.step == 10 and all(math.isfinite(x)
                                             for x in losses)
              and not all(math.isfinite(x) for x in dump['window_losses']),
              'nan_loss drill: step %d, epoch losses %s, dump %s'
              % (model.state.step, losses, dump['window_losses']))
        print('drill nan_loss@step=5 (SAVE_EVERY_N_STEPS=2): one rewind to '
              'step 4, 12 batches end at step %d, epoch losses %s (finite), '
              'dump window %s; train() %.2f s [%s]'
              % (model.state.step, ['%.4f' % x for x in losses],
                 dump['window_losses'], nan_s, gpu))
        del model

        # sigterm: the snapshot at step 5 and the marker, then a resume
        root = new_root('sigterm')
        knobs = dict(NUM_TRAIN_EPOCHS=3, NUM_BATCHES_TO_LOG_PROGRESS=2,
                     USE_TENSORBOARD=True)
        model = drill_model(prefix, root, FAULT_INJECT='sigterm@step=5',
                            **knobs)
        zero_counts()
        model.train()
        add(drill_counts(5, 'sigterm drill'))
        snapshots = root / 'm' / 'saved_model__step-snapshots'
        marker = json.loads((snapshots / 'PREEMPTED.json').read_text())
        check(model.state.step == 5 and (snapshots / '5').is_dir()
              and marker['step'] == 5
              and marker['last_complete_epoch'] == 0,
              'sigterm drill: step %d, marker %s'
              % (model.state.step, marker))
        del model
        resumed = drill_model(prefix, root, load=True, **knobs)
        check(resumed.state.step == 5 and resumed._start_epoch == 1
              and not (snapshots / 'PREEMPTED.json').exists(),
              'resume after sigterm: step %d, epoch %d'
              % (resumed.state.step, resumed._start_epoch))
        zero_counts()
        resumed.train()
        add(drill_counts(8, 'resume after sigterm'))
        check(resumed.state.step == 13, 'resumed to step %d'
              % resumed.state.step)
        by_tag = {}
        for line in (root / 'm' / 'summaries' / 'metrics.jsonl'
                     ).read_text().splitlines():
            entry = json.loads(line)
            by_tag.setdefault(entry['tag'], []).append(entry['step'])
        check('train/loss' in by_tag and all(
            steps == sorted(steps) for steps in by_tag.values()),
            'metrics.jsonl: %s' % by_tag)
        print('drill sigterm@step=5: snapshot and PREEMPTED.json at step 5, '
              'resumed at epoch 2 to step %d; metrics.jsonl train/loss at '
              'steps %s [%s]' % (resumed.state.step, by_tag['train/loss'],
                                 gpu))
        del resumed

        # corrupt_snapshot: snapshots 2, 4, 6 (two kept), 6 corrupted
        root = new_root('corrupt')
        model = drill_model(prefix, root, NUM_TRAIN_EPOCHS=2,
                            SAVE_EVERY_N_STEPS=2,
                            FAULT_INJECT='corrupt_snapshot@save=2')
        zero_counts()
        model.train()
        add(drill_counts(8, 'corrupt_snapshot drill'))
        del model
        resumed = drill_model(prefix, root, load=True, NUM_TRAIN_EPOCHS=2)
        snapshots = root / 'm' / 'saved_model__step-snapshots'
        check(resumed.state.step == 4 and (snapshots / '6.corrupt').is_dir()
              and not (snapshots / '6').exists(),
              'corrupt_snapshot drill: resumed at step %d, snapshots %s'
              % (resumed.state.step, sorted(p.name for p in
                                            snapshots.iterdir())))
        print('drill corrupt_snapshot@save=2: the restore fell back from '
              'step 6 to 4, quarantined %s [%s]'
              % (sorted(p.name for p in snapshots.iterdir()), gpu))
        del resumed
        torch.cuda.empty_cache()

        # hang_input: a CLI process on the card, aborted by the watchdog
        root = new_root('hang')
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get('PYTHONPATH', ''))
        env.pop('FAULT_INJECT', None)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'code2vec_tpu_torch.cli', '--data',
             str(prefix), '--epochs', '1', '--fused-ce', '--no-data-cache',
             '--fault-inject', 'hang_input@step=1', '--watchdog-secs', '10',
             '--device', DEVICE, '-v', '0'], cwd=str(root), env=env,
            capture_output=True,
            text=True, timeout=300)
        hang_s = time.perf_counter() - t0
        stacks_path = root / 'telemetry' / 'watchdog_stacks.txt'
        stacks = stacks_path.read_text() if stacks_path.exists() else ''
        # the label names the batch the loop waits for: the staging ring
        # reads DEVICE_PREFETCH_BATCHES (2) ahead, so on the card the hang
        # at the reader's second batch holds up the first handout
        check(proc.returncode == -signal.SIGABRT
              and 'waiting on: next staged batch (batch 0)' in stacks
              and 'fault_site_batches' in stacks,
              'hang_input drill: exit %s, stacks %r, stderr %s'
              % (proc.returncode, stacks[:300], proc.stderr[-2000:]))
        print('drill hang_input@step=1 (--watchdog-secs 10): the CLI process '
              'ended by SIGABRT after %.1f s; watchdog_stacks.txt names the '
              'wait (%s) and the hung frame (fault_site_batches) [%s]'
              % (hang_s, stacks.splitlines()[0], gpu))
    finally:
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    return {'resilience': total}


def source_to_repl_phase(rng, gpu: str) -> dict:
    """The README's path from source, on the card: the extractor built
    from extractor/src (timed); Java files from scripts/gen_java_corpus.py
    (a subprocess); data/extract_driver.py and data/preprocess.py (each a
    subprocess); then ``cli.main`` in process: train one epoch at full
    width (dims 128/128/384, 200 contexts, B 1024) over the preprocessed
    vocabulary, ``--load --test``, and ``--predict`` with the shell's
    input scripted (one file, then exit): each turn launches the ragged
    forward once and no other kernel. Prints the predicted names.
    Returns the launches per path."""
    import builtins
    import contextlib
    import io
    import subprocess
    from code2vec_tpu_torch import cli, hostbuild
    from code2vec_tpu_torch.serving import extractor_bridge
    from code2vec_tpu_torch.vocab import VocabType
    root = Path(tempfile.mkdtemp(prefix='source_', dir=SMOKE_DIR))
    try:
        fresh = root / 'bin' / 'c2v-extract'
        t0 = time.perf_counter()
        hostbuild.build(str(fresh), str(Path(
            extractor_bridge.EXTRACTOR_SOURCES) / 'main.cpp'),
            extractor_bridge.GXX_FLAGS)
        build_s = time.perf_counter() - t0
        binary = extractor_bridge.build_extractor()
        env = dict(os.environ, PYTHONPATH=str(ROOT))

        def run(*args):
            proc = subprocess.run([sys.executable, *args], cwd=root,
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            check(proc.returncode == 0, '%s failed: %s'
                  % (' '.join(args), proc.stderr[-2000:]))
            return proc

        t0 = time.perf_counter()
        run(str(ROOT / 'scripts' / 'gen_java_corpus.py'), '-o', 'java',
            '--classes', '1200', '--seed', '7')
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for split in ('train', 'val', 'test'):
            run('-m', 'code2vec_tpu_torch.data.extract_driver', '--dir',
                'java/' + split, '--output', split + '.raw', '--workers',
                '4', '--extractor', binary)
        extract_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run('-m', 'code2vec_tpu_torch.data.preprocess', '-trd', 'train.raw',
            '-vd', 'val.raw', '-ted', 'test.raw', '-o', 'ds', '--seed', '0')
        preprocess_s = time.perf_counter() - t0
        rows = {split: (root / ('ds.%s.c2v' % split)).read_text().count('\n')
                for split in ('train', 'val', 'test')}
        print('source: extractor g++ build %.1f s; gen_java_corpus %.1f s, '
              '%d files; extract_driver %.1f s; preprocess %.1f s; rows %s'
              % (build_s, gen_s, len(list((root / 'java').rglob('*.java'))),
                 extract_s, preprocess_s, rows))

        save = root / 'models' / 'saved_model'
        device = ['--device', DEVICE, '-v', '0']
        zero_counts()
        t0 = time.perf_counter()
        trained = cli.main(['--data', str(root / 'ds'), '--test',
                            str(root / 'ds.val.c2v'), '--save', str(save),
                            '--epochs', '1'] + device)
        loaded = cli.main(['--load', str(save), '--test',
                           str(root / 'ds.test.c2v')] + device)
        train_eval = launch_counts()
        steps = -(-rows['train'] // 1024)
        check(trained.state.step == steps
              and math.isfinite(trained.eval_history[-1]['loss']),
              'source train: %d steps, %s' % (trained.state.step,
                                             trained.eval_history))
        sizes = [trained.vocabs.get(t).size for t in
                 (VocabType.Token, VocabType.Path, VocabType.Target)]
        print('source cli: train 1 epoch (%d steps) + evaluate + --load '
              '--test in %.1f s, vocab %s; after the epoch %s; launches %s '
              '[%s]' % (steps, time.perf_counter() - t0, sizes,
                        {k: trained.eval_history[-1][k]
                         for k in ('loss', 'f1')}, train_eval, gpu))
        del trained, loaded

        source = sorted((root / 'java' / 'test').rglob('*.java'))[0]
        turns = []
        replies = iter(['', 'exit'])

        def scripted_input():
            turns.append(launch_counts())
            return next(replies)

        out = io.StringIO()
        real_input = builtins.input
        builtins.input = scripted_input
        try:
            with contextlib.redirect_stdout(out):
                cli.main(['--load', str(save), '--predict', '--input-file',
                          str(source)] + device)
        finally:
            builtins.input = real_input
        report = out.getvalue()
        turn = {n: turns[1][n] - turns[0][n] for n in turns[0]}
        check(turn == {n: int(n == 'ragged_fwd') for n in turn},
              'a shell turn launched %s' % turn)
        # each method's name and its first prediction
        names, predicted = [], []
        for line in report.splitlines():
            if line.startswith('Original name:'):
                names.append(line.split('\t', 1)[1])
            elif 'predicted: ' in line and len(predicted) < len(names):
                predicted.append(line.split('predicted: ', 1)[1])
        check(names and 'Attention:' in report
              and report.rstrip().endswith('Exiting...'),
              'shell report: %r' % report[-2000:])
        print('repl: %s, %d methods; (name, first prediction) %s; one turn '
              'launched %s [%s]' % (source.name, len(names),
                                    list(zip(names, predicted)), turn, gpu))
        return {'source': {n: train_eval[n] for n in STEP_KERNELS},
                'repl': {'ragged_fwd': turn['ragged_fwd']}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ serving engine
ENGINE_BUCKETS = ((8, 5), (64, 50), (512, 400), (1024, 1000))
ENGINE_TIERS = ('topk', 'attention', 'full')
LOAD_THREADS = 8
LOAD_SECONDS = 3.0
# the engine against Code2VecModel.predict is held bit for bit: predict
# packs at bucketed_capacity and the engine at a ladder rung, but the bf16
# forward's tiles follow the examples' starts, not the capacity, and a
# capacity's extra slots are PAD that adds 0.0


def engine_lines(rng, n: int, sizes, max_contexts: int, draw: int) -> list:
    """``n`` lines, two of them with no valid context (one with none at
    all, one whose every context is the all-PAD triple: count 0 on the
    wire); the rest at the java14m fill (draw 1), at 1-3 contexts (draw
    0) or at 100-200 (draw 2), so one bucket lands on several capacity
    rungs."""
    counts = (rng.integers(1, 4, n - 2) if draw == 0 else
              rng.integers(100, max_contexts + 1, n - 2) if draw == 2
              else context_counts(rng, max(n - 2, 4), max_contexts)[:n - 2])
    return make_lines(rng, n - 2, sizes, max_contexts, counts) + [
        target_word(1) + ' ', target_word(2) + ' ,, ,,']


def tile_lines(rng, n: int, sizes) -> list:
    """``n`` lines of exactly 64 contexts: coalesced, each row fills one
    64-slot tile of the bf16 ragged forward whatever its position in the
    batch, so a row's arithmetic does not depend on its batchmates."""
    return make_lines(rng, n, sizes, 64, np.full(n, 64))


def result_diff(got, want, what: str) -> float:
    """Largest |difference| of the scores, attention and code vectors of
    two result lists; names, top-k words and attention keys must be
    equal."""
    check(len(got) == len(want), '%s: %d results for %d'
          % (what, len(got), len(want)))
    diff = 0.0
    for g, w in zip(got, want):
        check(g.original_name == w.original_name
              and g.topk_predicted_words == w.topk_predicted_words,
              '%s: top-k words differ' % what)
        check(g.attention_per_context.keys() == w.attention_per_context.keys(),
              '%s: attention contexts differ' % what)
        for a, b in ((g.topk_predicted_words_scores,
                      w.topk_predicted_words_scores),
                     (g.code_vector, w.code_vector),
                     (np.array(list(g.attention_per_context.values())),
                      np.array(list(w.attention_per_context.values())))):
            check((a is None) == (b is None), '%s: outputs differ' % what)
            if a is not None and np.size(a):
                diff = worst(diff, float(np.abs(
                    np.asarray(a, np.float64) - np.asarray(b, np.float64)
                ).max()))
    return diff


def engine_parity(engine, model, rng, gpu: str, buckets=ENGINE_BUCKETS
                  ) -> list:
    """The engine against ``Code2VecModel.predict`` at each bucket and
    tier (lines with count-0 and all-PAD rows), then the same cases
    again with the graph keys in a shuffled order. Returns the cases
    ``(lines, tier, want)``."""
    config = model.config
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    cases, rungs = [], []
    for bucket, n in buckets:
        for draw in range(3):
            lines = engine_lines(rng, n, sizes, config.MAX_CONTEXTS, draw)
            for tier in ENGINE_TIERS:
                want = model.predict(lines, tier=tier)
                got = engine.predict(lines, tier=tier, timeout=300)
                dispatch = engine.last_dispatch
                check(dispatch['bucket'] == bucket,
                      'engine bucket %r for %d lines' % (dispatch, n))
                diff = result_diff(got, want, 'engine vs predict b%d %s'
                                   % (bucket, tier))
                check(diff == 0, 'engine vs predict at bucket %d tier %s: '
                      'max |diff| %.3g' % (bucket, tier, diff))
                cases.append((lines, tier, want))
                rungs.append(dispatch['capacity'])
    order = rng.permutation(len(cases))
    for i in order:
        lines, tier, want = cases[i]
        check(result_diff(engine.predict(lines, tier=tier, timeout=300),
                          want, 'shuffled replay') == 0,
              'a replay in shuffled key order differs')
    print('engine parity (%s wire): %d cases (buckets %s x tiers %s, '
          'rungs %s, count-0 and all-PAD rows) then again in shuffled key '
          'order: top-k, scores, attention and code vectors bit-equal to '
          'Code2VecModel.predict [%s]'
          % (engine.wire, len(cases), [b for b, _ in buckets],
             list(ENGINE_TIERS), sorted(set(rungs)), gpu))
    return cases


def small_call_latency(engine, model, lines, gpu: str, reps: int = 30
                       ) -> tuple:
    """p50 ms of one request of ``lines`` (bucket 8) alone: through the
    engine, and through ``Code2VecModel.predict`` (eager)."""
    def p50(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)
    engine_ms = p50(lambda: engine.predict(lines, tier='topk', timeout=300))
    eager_ms_ = p50(lambda: model.predict(lines, tier='topk'))
    print('engine latency, one request of %d lines (bucket 8, topk), p50 '
          'of %d: engine %.2f ms, eager predict %.2f ms [%s]'
          % (len(lines), reps, engine_ms, eager_ms_, gpu))
    return engine_ms, eager_ms_


def replay_device_ms(engine, keys, cache: dict) -> dict:
    """Each graph's device ms (one replay, CUDA events), cached."""
    for key in keys:
        if key not in cache:
            cache[key] = engine.ladder.replay_ms(key)
    return cache


def engine_load(engine, pool_lines, mix, seconds: float, gpu: str,
                tag: str, ms_cache: dict) -> dict:
    """LOAD_THREADS caller threads submit requests of 1-64 lines from
    ``pool_lines`` at tiers from ``mix`` for ``seconds`` each: requests/s,
    rows/s, p50/p99 latency, the mean batch fill and the card's idle
    share (1 - replays x each graph's device ms / wall). No kernel
    wrapper may launch meanwhile: every batch is a graph replay."""
    import threading
    zero_counts()
    before = engine.stats()
    replays0 = engine.ladder.counts()[1]
    done, errors = [], []
    lock = threading.Lock()

    def caller(seed):
        r = np.random.default_rng(seed)
        end = time.perf_counter() + seconds
        mine = []
        try:
            while time.perf_counter() < end:
                n = int(r.integers(1, 65))
                start = int(r.integers(0, len(pool_lines) - n))
                tier = mix[int(r.integers(len(mix)))]
                t0 = time.perf_counter()
                results = engine.predict(pool_lines[start:start + n],
                                         tier=tier, timeout=300)
                mine.append((start, n, tier, time.perf_counter() - t0))
                check(len(results) == n, 'wrong result count under load')
        except BaseException as exc:
            errors.append(exc)
        with lock:
            done.extend(mine)

    threads = [threading.Thread(target=caller, args=(100 + i,))
               for i in range(LOAD_THREADS)]
    t0 = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    wall = time.perf_counter() - t0
    check(not errors, 'load: %r' % errors[:3])
    launched = {k: n for k, n in launch_counts().items() if n}
    check(not launched, 'kernel wrappers launched under load (no graph '
          'replay): %s' % launched)
    after = engine.stats()
    delta = {k: n - replays0.get(k, 0)
             for k, n in engine.ladder.counts()[1].items()
             if n > replays0.get(k, 0)}
    replay_device_ms(engine, delta, ms_cache)
    rows = after['rows_total'] - before['rows_total']
    padded = sum(n * k.bucket for k, n in delta.items())
    device_ms = sum(n * ms_cache[k] for k, n in delta.items())
    check(after['graph_captures_after_warmup'] == 0,
          'graph captures after warm-up: %d'
          % after['graph_captures_after_warmup'])
    lat = sorted(d[3] for d in done)
    report = {
        'requests': len(done), 'rows': rows, 'seconds': wall,
        'requests_per_s': len(done) / wall, 'rows_per_s': rows / wall,
        'p50_ms': after['latency_ms']['p50_ms'],
        'p99_ms': after['latency_ms']['p99_ms'],
        'client_p50_ms': 1e3 * lat[len(lat) // 2],
        'client_p99_ms': 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        'batches': after['batches_total'] - before['batches_total'],
        'fill': rows / max(padded, 1), 'replays': sum(delta.values()),
        'device_ms': device_ms, 'idle': 1 - device_ms / (1e3 * wall),
        'requests_done': done}
    print('engine load (%s, %s wire, %d threads x %.0f s, tiers %s): '
          '%d requests, %.1f requests/s, %.0f rows/s, latency p50 %.2f ms '
          'p99 %.2f ms (stats(), last 512; all requests: p50 %.2f p99 '
          '%.2f), %d batches, mean fill %.3f, %d replays, device %.1f ms '
          'of %.2f s wall: idle %.1f%%, captures after warm-up 0, no '
          'wrapper launch [%s]'
          % (tag, engine.wire, LOAD_THREADS, seconds, list(mix),
             len(done), report['requests_per_s'], report['rows_per_s'],
             report['p50_ms'], report['p99_ms'], report['client_p50_ms'],
             report['client_p99_ms'], report['batches'], report['fill'],
             report['replays'], device_ms, wall, 100 * report['idle'], gpu))
    return report


def naive_loop(model, pool_lines, requests, seconds: float, gpu: str
               ) -> float:
    """The same requests through ``Code2VecModel.predict``, one at a time,
    for at most ``seconds``: rows/s."""
    rows, t0 = 0, time.perf_counter()
    for start, n, tier, _lat in requests:
        model.predict(pool_lines[start:start + n], tier=tier)
        rows += n
        if time.perf_counter() - t0 > seconds:
            break
    rate = rows / (time.perf_counter() - t0)
    print('naive predict loop: %d rows in %.2f s, %.0f rows/s [%s]'
          % (rows, time.perf_counter() - t0, rate, gpu))
    return rate


def kernel_trace(engine, lines, tier: str, names, gpu: str,
                 calls: int = 4) -> dict:
    """A torch.profiler trace of ``calls`` engine dispatches: the device
    kernels named ``names`` must have run in their graph replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    replays0 = engine.stats()['graph_replays']
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            engine.predict(lines, tier=tier, timeout=300)
        torch.cuda.synchronize()
    replays = engine.stats()['graph_replays'] - replays0
    counts = {name: 0 for name in names}
    for event in prof.events():
        for name in names:
            if name in event.name:
                counts[name] += 1
    check(all(n >= replays for n in counts.values()),
          'profiler: kernels %s in %d graph replays' % (counts, replays))
    print('engine trace (%s wire): %d dispatches, %d graph replays; '
          'kernels in the trace: %s [%s]'
          % (engine.wire, calls, replays, counts, gpu))
    return counts


def engine_rollover(engine, vectors_engine, model, lines, gpu: str) -> None:
    """Swap to a saved step that agrees, roll a perturbed set back, time a
    vectors-only canary out: no capture, and every result served during
    a canary equals the serving slot's."""
    captures = (engine.stats()['graph_captures'],
                vectors_engine.stats()['graph_captures'])
    baseline = engine.predict(lines, tier='topk', timeout=300)

    def feed(handle, what):
        served = 0
        while not handle.done() and served < 200:
            got = engine.predict(lines, tier='topk', timeout=300)
            check(result_diff(got, baseline, what) == 0,
                  '%s: a result served during the canary differs' % what)
            served += 1
        return handle.result(timeout=300), served

    t0 = time.perf_counter()
    handle = engine.load_params(1)
    load_s = time.perf_counter() - t0
    report, fed = feed(handle, 'canary of step 1')
    check(report['swapped'] and report['agreement'] == 1.0,
          'rollover to an agreeing step: %r' % report)
    check(engine.stats()['serving_slot'] == 1, 'serving slot after swap')
    check(result_diff(engine.predict(lines, tier='topk', timeout=300),
                      baseline, 'after swap') == 0,
          'results after the swap differ')
    params = engine.params
    perturbed = params._replace(target_embedding=-params.target_embedding)
    report2, fed2 = feed(engine.load_params(perturbed), 'perturbed canary')
    del perturbed
    check(not report2['swapped'] and report2['agreement'] < 0.9,
          'rollover of a perturbed set: %r' % report2)
    handle = vectors_engine.load_params(1, canary_batches=2)
    vectors_engine.canary_timeout_s = 0.05
    time.sleep(0.1)
    vectors_engine.predict(lines, tier='vectors', timeout=300)
    report3 = handle.result(timeout=60)
    check(not report3['swapped'] and 'timed out' in report3['reason'],
          'vectors-only canary: %r' % report3)
    after = (engine.stats()['graph_captures'],
             vectors_engine.stats()['graph_captures'])
    check(after == captures, 'captures during rollover: %s -> %s'
          % (captures, after))
    print('engine rollover: load_params(step 1) restored + copied into '
          'the idle slot in %.2f s, swapped at agreement %.3f after %d '
          'batches (%d calls fed); perturbed set rolled back at agreement '
          '%.3f (%d calls); vectors-only canary %s; results during each '
          'canary equal the serving slot\'s; 0 captures [%s]'
          % (load_s, report['agreement'], report['batches'], fed,
             report2['agreement'], fed2, report3['reason'], gpu))


def engine_overload(engine, line: str, filler: str, gpu: str) -> None:
    """``slow_dispatch`` with a bound of 8 rows and a 60 ms deadline:
    typed sheds and expiries, admitted results bit-equal to the line
    served alone (``line`` fills one tile, so its coalesced copies keep
    its arithmetic); and how far a row moves when a batchmate
    (``filler``) shifts it off a tile edge."""
    from code2vec_tpu_torch.resilience import faults
    from code2vec_tpu_torch.serving.errors import (DeadlineExceeded,
                                                   EngineOverloaded)
    unloaded = engine.predict([line], tier='topk', timeout=300)
    (shifted,) = engine.predict([filler, line], tier='topk',
                                timeout=300)[1:]
    offset_words = (shifted.topk_predicted_words
                    == unloaded[0].topk_predicted_words)
    offset_diff = float(np.abs(
        shifted.topk_predicted_words_scores.astype(np.float64)
        - unloaded[0].topk_predicted_words_scores).max())
    bound, engine.queue_bound = engine.queue_bound, 8
    try:
        faults.configure('slow_dispatch@req=0..63')
        plug = engine.submit([line], tier='topk')
        t_end = time.perf_counter() + 10
        while engine.queue_depth.snapshot() != 0 and \
                time.perf_counter() < t_end:
            time.sleep(0.001)
        doomed = [engine.submit([line], tier='topk', deadline_ms=60.0)
                  for _ in range(4)]
        admitted, shed = [], 0
        for _ in range(10):
            try:
                admitted.append(engine.submit([line], tier='topk'))
            except EngineOverloaded:
                shed += 1
        check(shed == 6 and len(admitted) == 4,
              'overload: %d shed, %d admitted' % (shed, len(admitted)))
        check(all(isinstance(f.exception(timeout=60), DeadlineExceeded)
                  for f in doomed), 'overload: deadlined requests')
        for future in admitted + [plug]:
            check(result_diff(future.result(timeout=60), unloaded,
                              'overload') == 0,
                  'a result served under overload differs')
    finally:
        faults.configure('')
        engine.queue_bound = bound
    print('engine overload: slow_dispatch, bound 8 rows: 6 shed '
          '(EngineOverloaded), 4 expired (DeadlineExceeded), 5 served bit '
          'for bit; the line behind a batchmate off the tile edge: top-k '
          'words %s, scores max |diff| %.3g [%s]'
          % ('equal' if offset_words else 'DIFFER', offset_diff, gpu))


def engine_close_drain(engine, lines, gpu: str) -> None:
    """Requests parked in the coalescing window are all served by
    ``close(drain=True)``."""
    want = [engine.predict([line], tier='topk', timeout=300)
            for line in lines]
    engine.max_delay_s = 30.0
    futures = [engine.submit([line], tier='topk') for line in lines]
    engine.close(drain=True)
    for future, expected in zip(futures, want):
        check(result_diff(future.result(timeout=60), expected,
                          'drain') == 0, 'close(drain=True) result differs')
    print('engine close(drain=True): %d parked requests served [%s]'
          % (len(lines), gpu))


def engine_phase(model, rng, gpu: str) -> dict:
    """The serving engine at java14m width on the packed wire: warm-up,
    parity, load, kernel evidence, rollover, overload, drain. Returns the
    ragged forward's wrapper launches in the engine's warm-up (an eager
    pass per key, a capture per key and slot) and the replays of the
    graphs that hold it."""
    import dataclasses
    import torch
    from code2vec_tpu_torch.model_api import ServingParamSource
    from code2vec_tpu_torch.models.functional import Code2VecParams
    from code2vec_tpu_torch.serving.engine import ServingEngine
    ckpt_dir = SMOKE_DIR / 'engine_checkpoints'
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    store = model._store_for(str(ckpt_dir / 'model'))
    names = Code2VecParams._fields
    t0 = time.perf_counter()
    for step in (0, 1):
        store.save_training(params=dict(zip(names, model.backend.params)),
                            opt_state={}, step=step, epoch=0)
    save_s = time.perf_counter() - t0
    source = ServingParamSource(model, store)
    zero_counts()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    engine = model.serving_engine(param_source=source, params_step=0,
                                  max_delay_ms=2.0)
    stats = engine.stats()
    keys = engine.ladder.keys()
    check(engine.warm_captures == 2 * len(keys) == stats['graph_captures'],
          'warm-up captured %d graphs for %d keys x 2 slots'
          % (engine.warm_captures, len(keys)))
    # one eager pass a key, then one capture a key and slot
    launches = launch_counts()['ragged_fwd']
    check(launches == 3 * len(keys), 'the ragged forward\'s wrapper ran %d '
          'times in the warm-up of %d keys' % (launches, len(keys)))
    pool = engine.ladder.pool_bytes()
    slot_bytes = engine.ladder.slot_bytes() // 2
    print('engine warm-up (packed wire): %d keys (buckets %s, rungs %s, '
          'tiers %s) x 2 parameter slots = %d graphs captured in %.1f s; '
          'shared pool %s bytes, reserved +%d bytes, %d bytes a slot '
          '(bf16), pinned %d bytes; 2 checkpoints saved in %.1f s [%s]'
          % (len(keys), list(engine.buckets),
             {b: list(r) for b, r in engine.capacities.items()},
             list(engine.tiers), engine.warm_captures, engine.warmup_s,
             pool, torch.cuda.memory_reserved() - reserved0, slot_bytes,
             stats['ladder']['pinned_bytes'], save_s, gpu))
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    cases = engine_parity(engine, model, rng, gpu)
    b8 = small_call_latency(engine, model,
                            next(c[0] for c in cases if len(c[0]) == 5
                                 and c[1] == 'topk'), gpu)
    pool_lines = make_lines(rng, 4096, sizes, model.config.MAX_CONTEXTS)
    ms_cache = {}
    topk = engine_load(engine, pool_lines, ('topk',), LOAD_SECONDS, gpu,
                       'topk', ms_cache)
    mixed = engine_load(engine, pool_lines, ENGINE_TIERS, LOAD_SECONDS, gpu,
                        'mixed tiers', ms_cache)
    naive = naive_loop(model, pool_lines, topk['requests_done'],
                       LOAD_SECONDS, gpu)
    check(topk['rows_per_s'] >= naive,
          'engine %.0f rows/s below the naive loop\'s %.0f'
          % (topk['rows_per_s'], naive))
    print('engine graph device ms (one replay): %s [%s]'
          % (', '.join('b%d/c%d/%s %.4f' % (k.bucket, k.rung, k.tier,
                                            ms_cache[k])
                       for k in sorted(ms_cache)), gpu))
    trace = kernel_trace(engine, next(c[0] for c in cases
                                      if len(c[0]) == 50), 'topk',
                         ('ragged_fwd_plan_kernel', 'ragged_fwd_tile_kernel',
                          'ragged_merge_kernel'), gpu)
    small = dataclasses.replace(model.config, SERVING_BATCH_BUCKETS='8,64')
    vectors_engine = ServingEngine(
        small, model.backend, model.backend.params, model.vocabs,
        decode_table=model._target_index_to_word, tiers=('vectors', 'topk'),
        param_source=source, max_delay_ms=0.0).warmup()
    try:
        engine_rollover(engine, vectors_engine, model, cases[0][0], gpu)
    finally:
        vectors_engine.close()
    tiles = tile_lines(rng, 5, sizes)
    engine_overload(engine, tiles[0], cases[0][0][0], gpu)
    replays = engine.stats()['graph_replays']
    engine_close_drain(engine, tiles, gpu)
    del engine, vectors_engine
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {'launches': launches, 'replays': replays,
            'rows_per_s': topk['rows_per_s'], 'naive_rows_per_s': naive,
            'trace': trace, 'b8_p50_ms': b8}


def engine_planes_phase(model, rng, gpu: str) -> dict:
    """The engine on the plane wire (encode kernel): one parameter slot,
    parity at each bucket and tier, a short load, kernel evidence."""
    import torch
    zero_counts()
    engine = model.serving_engine(max_delay_ms=2.0)
    try:
        keys = engine.ladder.keys()
        launches = launch_counts()['encode']
        check(engine.warm_captures == len(keys) and launches == 2 * len(keys),
              'plane warm-up: %d captures, %d encode launches for %d keys'
              % (engine.warm_captures, launches, len(keys)))
        print('engine warm-up (planes wire): %d graphs in %.1f s, shared '
              'pool %s bytes [%s]' % (engine.warm_captures, engine.warmup_s,
                                      engine.ladder.pool_bytes(), gpu))
        sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                           model.vocabs.path_vocab,
                                           model.vocabs.target_vocab))
        cases = engine_parity(engine, model, rng, gpu)
        pool_lines = make_lines(rng, 2048, sizes, model.config.MAX_CONTEXTS)
        load = engine_load(engine, pool_lines, ('topk',), 2.0, gpu, 'topk',
                           {})
        trace = kernel_trace(engine, next(c[0] for c in cases
                                          if len(c[0]) == 50), 'topk',
                             ('encode_bf16_kernel',), gpu)
        replays = engine.stats()['graph_replays']
    finally:
        engine.close()
    del engine
    torch.cuda.empty_cache()
    return {'launches': launches, 'replays': replays,
            'rows_per_s': load['rows_per_s'], 'trace': trace}


# ------------------------------------------------------------- the index
INDEX_ROWS = 1 << 20            # the exact tier's synthetic rows
INDEX_IVF_ROWS = 1 << 19        # the IVF and quantized tiers' rows
INDEX_BULK_LINES = 65536        # 64 batches of 1024 through the bulk feed
INDEX_EXPORT_LINES = 4096       # the text export's corpus
INDEX_DIM = 384
INDEX_K = 10
INDEX_QUERIES = 256             # recall samples
INDEX_PQ_M = 96
INDEX_INSERTS = 4096
INDEX_ENGINE_SECONDS = 2.0
INDEX_PARITY_GAP = 1e-5
INDEX_BUCKETS = (1, 8, 64, 512)


def index_rows(n: int, seed: int) -> np.ndarray:
    """(n, 384) float32 rows of a seeded clustered generator on the card:
    ~100 rows per unit-norm center plus noise of norm ~0.15
    (tests/test_index.py::clustered_corpus at the code vector's width)."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    centers = torch.randn((max(1, n // 100), INDEX_DIM), generator=gen,
                          device=DEVICE)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    out = np.empty((n, INDEX_DIM), np.float32)
    step = 1 << 18
    for start in range(0, n, step):
        m = min(step, n - start)
        pick = torch.randint(0, centers.shape[0], (m,), generator=gen,
                             device=DEVICE)
        noise = torch.randn((m, INDEX_DIM), generator=gen, device=DEVICE)
        out[start:start + m] = (centers[pick] + (0.15 / math.sqrt(
            INDEX_DIM)) * noise).cpu().numpy()
    return out


def near_queries(rows: np.ndarray, n: int, seed: int) -> np.ndarray:
    """``n`` store rows plus noise of 0.01 a coordinate (the reference's
    recall queries, tests/test_index.py)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(rows.shape[0], n, replace=False)
    return (np.asarray(rows[pick], np.float32)
            + 0.01 * rng.normal(size=(n, rows.shape[1]))).astype(np.float32)


def device_ms(fn) -> tuple:
    """(result, ms between CUDA events around the work ``fn`` enqueues)."""
    import torch
    if DEVICE != 'cuda':
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def numpy_topk(scores: np.ndarray, k: int) -> tuple:
    """(values, ids) of the k largest scores a row, ties by lowest id."""
    part = np.argpartition(-scores, k, axis=-1)[:, :k + 1]
    vals = np.take_along_axis(scores, part, axis=-1)
    order = np.lexsort((part, -vals), axis=-1)[:, :k]
    return (np.take_along_axis(vals, order, axis=-1),
            np.take_along_axis(part, order, axis=-1))


def ranked_parity(got_v, got_i, want_v, want_i, what: str) -> int:
    """Scores within INDEX_PARITY_GAP, and equal ids wherever the wanted
    score is more than that from both neighbours (``want_*`` have k + 1
    columns, so rank k's lower neighbour counts). Returns the ranks
    held to equal ids."""
    k = got_i.shape[1]
    err = float(np.abs(got_v - want_v[:, :k]).max())
    check(err <= INDEX_PARITY_GAP, '%s: scores differ by %.3g' % (what, err))
    gaps = -np.diff(want_v, axis=1)                 # (Q, k)
    clear = gaps[:, :k] > INDEX_PARITY_GAP
    clear[:, 1:] &= gaps[:, :k - 1] > INDEX_PARITY_GAP
    wrong = int(((got_i != want_i[:, :k]) & clear).sum())
    check(wrong == 0, '%s: %d separated ranks differ' % (what, wrong))
    return int(clear.sum())


def bucket_latencies(search, device_of, fill=None, reps: int = 5) -> dict:
    """Per query bucket, medians of ``reps`` calls: the host ms of
    ``search(queries)``, the device ms ``device_of(queries)`` reads for
    it, and the host candidate fill's ms where ``fill`` reads it."""
    rng = np.random.default_rng(21)
    out = {}
    for bucket in INDEX_BUCKETS:
        host, device, fills = [], [], []
        for _ in range(reps):
            queries = rng.normal(size=(bucket, INDEX_DIM)).astype(np.float32)
            t0 = time.perf_counter()
            search(queries)
            host.append(1e3 * (time.perf_counter() - t0))
            device.append(device_of(queries))
            if fill is not None:
                fills.append(1e3 * fill())
        out[bucket] = {'host_ms': statistics.median(host),
                       'device_ms': statistics.median(device)}
        if fill is not None:
            out[bucket]['fill_ms'] = statistics.median(fills)
    return out


def probe_spans(index) -> list:
    """Wrap ``index._probe``, the device half of an IVF or quantized
    search, so each call appends its CUDA-event ms to the list returned."""
    spans = []
    real = index._probe

    def probe(*args):
        out, ms = device_ms(lambda: real(*args))
        spans.append(ms)
        return out

    index._probe = probe
    return spans


def bulk_store(model, lines, root: Path) -> tuple:
    """``lines`` written as a corpus under ``root``, their code vectors
    streamed through ``iter_code_vector_batches`` into a labeled float16
    store: (store, the vectors as float32)."""
    from code2vec_tpu_torch.index import store as store_lib
    from code2vec_tpu_torch.serving import bulk
    corpus = root / 'bulk.c2v'
    corpus.write_text('\n'.join(lines) + '\n')
    labels, parts = [], []

    def chunks():
        for vectors, batch_labels in bulk.iter_code_vector_batches(
                model, str(corpus), with_labels=True):
            labels.extend(str(label) for label in batch_labels)
            parts.append(vectors)
            yield vectors

    store = store_lib.build(str(root / 'bulk.vecindex'), chunks(),
                            dtype='float16', labels=labels)
    return store, np.concatenate(parts)


def index_bulk_phase(model, rng, root: Path, gpu: str) -> tuple:
    """The bulk feed at java14m width: INDEX_BULK_LINES lines through
    ``iter_code_vector_batches`` into a labeled float16 store; the first
    batch against ``predict``'s vectors tier; ``export_code_vectors``
    against the stream. Returns (store, ragged launches, examples/s)."""
    from code2vec_tpu_torch.serving import bulk
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    lines = make_lines(rng, INDEX_BULK_LINES, sizes,
                       model.config.MAX_CONTEXTS)
    zero_counts()
    t0 = time.perf_counter()
    store, vectors = bulk_store(model, lines, root)
    seconds = time.perf_counter() - t0
    counts = {k: n for k, n in launch_counts().items() if n}
    size = model.config.TEST_BATCH_SIZE
    batches = INDEX_BULK_LINES // size
    check(counts == {'ragged_fwd': batches},
          'bulk feed launches %s for %d batches' % (counts, batches))
    names = [line.split(' ', 1)[0] for line in lines]
    check(store.count == vectors.shape[0] == INDEX_BULK_LINES
          and list(store.labels) == names and np.isfinite(vectors).all(),
          'bulk store: %d rows, labels out of order or vectors not finite'
          % store.count)
    # the first batch as predict lays it out (the same packed stream)
    want = np.stack([r.code_vector for r in model.predict(
        lines[:size], tier='vectors')])
    err = float(np.abs(vectors[:size] - want).max())
    check(np.allclose(vectors[:size], want, rtol=2e-5, atol=1e-6),
          'bulk vectors vs predict: max |diff| %.3g' % err)
    export = root / 'export.c2v'
    export.write_text('\n'.join(lines[:INDEX_EXPORT_LINES]) + '\n')
    t1 = time.perf_counter()
    n, path = bulk.export_code_vectors(model, str(export))
    export_s = time.perf_counter() - t1
    stream = np.concatenate([v for v, _l in bulk.iter_code_vector_batches(
        model, str(export))])
    check(n == INDEX_EXPORT_LINES and Path(path).read_text() == ''.join(
        ' '.join(map(str, vec)) + '\n' for vec in stream),
          'export_code_vectors text differs from the stream')
    rate = INDEX_BULK_LINES / seconds
    print('index bulk feed: %d lines at the java14m fill -> %d batches of '
          '%d through iter_code_vector_batches into a labeled float16 '
          'store in %.2f s (%.0f examples/s), ragged_fwd launches %d; the '
          'first batch vs predict\'s vectors tier max |diff| %.3g; '
          'export_code_vectors of %d lines in %.2f s equals the stream [%s]'
          % (INDEX_BULK_LINES, batches, size, seconds, rate,
             counts['ragged_fwd'], err, INDEX_EXPORT_LINES, export_s, gpu))
    return store, counts['ragged_fwd'], rate


def index_exact_phase(rows32, bulk_store, root: Path, gpu: str) -> tuple:
    """The exact tier over INDEX_ROWS synthetic rows plus the bulk rows,
    float16: the ledger, warm-up, latency per bucket, parity against
    numpy fp32, recall against a float32 copy, ``search_streamed``.
    Returns (index, report)."""
    import torch
    from code2vec_tpu_torch.index import store as store_lib
    from code2vec_tpu_torch.index.exact import ExactIndex, search_streamed
    from code2vec_tpu_torch.telemetry import memory as memory_lib
    step = 1 << 18
    t0 = time.perf_counter()
    store = store_lib.build(
        str(root / 'exact.vecindex'),
        [rows32[s:s + step] for s in range(0, rows32.shape[0], step)]
        + [bulk_store.all_rows()], dtype='float16', metric='cosine')
    build_s = time.perf_counter() - t0
    before = memory_lib.ledger().bucket_bytes('index')
    t0 = time.perf_counter()
    index = ExactIndex(store, device=DEVICE)
    attach_s = time.perf_counter() - t0
    index_bytes = memory_lib.ledger().bucket_bytes('index') - before
    check(index_bytes == store.count * INDEX_DIM * 2,
          'mem/index_bytes %d for %d f16 rows' % (index_bytes, store.count))
    t0 = time.perf_counter()
    index.warmup(INDEX_K)
    warmup_s = time.perf_counter() - t0

    def placed_ms(queries):
        q = torch.from_numpy(queries).to(DEVICE)
        return device_ms(lambda: index.search_placed(q, INDEX_K))[1]

    lat = bucket_latencies(lambda q: index.search(q, INDEX_K), placed_ms)
    # parity against numpy float32 on 64 queries
    queries = near_queries(rows32, 64, 22)
    got_v, got_i = index.search(queries, INDEX_K)
    q16 = store_lib.normalize_rows(queries).astype(np.float16).astype(
        np.float32)
    scores = np.empty((64, store.count), np.float32)
    for offset, shard in store.iter_shards():
        scores[:, offset:offset + shard.shape[0]] = q16 @ np.asarray(
            shard, np.float32).T
    want_v, want_i = numpy_topk(scores, INDEX_K + 1)
    del scores
    held = ranked_parity(got_v, got_i, want_v, want_i, 'exact vs numpy')
    t0 = time.perf_counter()
    str_v, str_i = search_streamed(store, queries, INDEX_K, device=DEVICE)
    streamed_s = time.perf_counter() - t0
    streamed_err = float(np.abs(str_v - got_v).max())
    check(np.array_equal(str_i, got_i) and streamed_err <= 1e-6,
          'search_streamed differs: scores by %.3g' % streamed_err)
    # the float16 store against a float32 one of the same rows
    exact32 = ExactIndex(np.concatenate(
        [rows32, np.asarray(bulk_store.all_rows(), np.float32)]),
        metric='cosine', device=DEVICE)
    recall_q = near_queries(rows32, INDEX_QUERIES, 23)
    _v, idx16 = index.search(recall_q, INDEX_K)
    _v, idx32 = exact32.search(recall_q, INDEX_K)
    recall16 = float(np.mean([len(set(a) & set(b)) / INDEX_K
                              for a, b in zip(idx16.tolist(),
                                              idx32.tolist())]))
    check(recall16 >= 0.97, 'float16 recall@10 %.4f vs float32' % recall16)
    del exact32
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()
    print('index exact tier: %d x %d float16 rows (%d synthetic + %d '
          'bulk), store built in %.1f s, attached in %.1f s, '
          'mem/index_bytes %d, warmup %.3f s; latency at k=%d (median of '
          '5; device: CUDA events): %s; vs numpy fp32 on 64 queries: '
          'scores within %g, %d separated ranks equal; search_streamed '
          '%.2f s, ids equal, scores within %.3g; float16 recall@10 vs '
          'float32 %.4f on %d queries [%s]'
          % (store.count, INDEX_DIM, rows32.shape[0], bulk_store.count,
             build_s, attach_s, index_bytes, warmup_s, INDEX_K,
             ', '.join('b%d host %.3f ms device %.3f ms'
                       % (b, v['host_ms'], v['device_ms'])
                       for b, v in lat.items()),
             INDEX_PARITY_GAP, held, streamed_s, streamed_err, recall16,
             INDEX_QUERIES, gpu))
    return index, {'latency': lat, 'recall16': recall16,
                   'warmup_s': warmup_s, 'index_bytes': index_bytes}


def search_all(index, queries) -> tuple:
    """Full probe, full re-rank: the order is the exact re-rank's."""
    index.rerank = 1 << 30
    return index.search(queries, INDEX_K, nprobe=index.n_clusters)


def index_ivf_phase(rows32, root: Path, gpu: str) -> dict:
    """The IVF and quantized tiers over INDEX_IVF_ROWS of the rows (a
    float32 store, so the exact re-rank and the exact tier score the same
    rows): k-means twice (identical sidecars), recall at nprobe 8, full
    probe against exact, bytes/vector, latency split into host fill and
    device, inserts and compaction against a fresh build."""
    import torch
    from code2vec_tpu_torch.index import quant as quant_lib
    from code2vec_tpu_torch.index import store as store_lib
    from code2vec_tpu_torch.index.exact import ExactIndex
    from code2vec_tpu_torch.index.ivf import (IVFIndex, default_clusters,
                                              measure_recall)
    step = 1 << 18
    n = INDEX_IVF_ROWS
    store = store_lib.build(str(root / 'ivf.vecindex'),
                            [rows32[s:min(n, s + step)]
                             for s in range(0, n, step)], metric='cosine')
    exact = ExactIndex(store, device=DEVICE)
    queries = near_queries(rows32[:n], INDEX_QUERIES, 24)
    kmeans_s, sidecars = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        ivf = IVFIndex.build(store, device=DEVICE)
        kmeans_s.append(time.perf_counter() - t0)
        with np.load(Path(store.path) / 'ivf.npz') as data:
            sidecars.append({key: data[key] for key in data.files})
    check(all(np.array_equal(sidecars[0][key], sidecars[1][key])
              and sidecars[0][key].dtype == sidecars[1][key].dtype
              for key in sidecars[0]), 'two k-means builds differ')
    check(ivf.n_clusters == default_clusters(n),
          'IVF clusters %d' % ivf.n_clusters)

    def tier_latency(index, spans):
        return bucket_latencies(lambda q: index.search(q, INDEX_K),
                                lambda _q: spans[-1],
                                fill=lambda: index.last_fill_s)

    spans = probe_spans(ivf)
    report = {'ivf': {'recall': measure_recall(ivf, exact, queries,
                                               k=INDEX_K),
                      'bytes_per_vector': INDEX_DIM * 4,
                      'latency': tier_latency(ivf, spans)}}
    del ivf
    real_train = quant_lib.train_pq
    pq_train_s = []

    def train_pq(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_train(*args, **kwargs)
        pq_train_s.append(time.perf_counter() - t0)
        return out

    quant_lib.train_pq = train_pq
    try:
        for kind in ('int8', 'pq'):
            t0 = time.perf_counter()
            index = quant_lib.QuantizedIVFIndex.build(
                store, kind=kind, pq_m=INDEX_PQ_M, device=DEVICE)
            build_s = time.perf_counter() - t0
            spans = probe_spans(index)
            recall = measure_recall(index, exact, queries, k=INDEX_K)
            check(recall >= 0.95, '%s recall@10 %.4f at nprobe %d'
                  % (kind, recall, index.nprobe))
            check(index.bytes_per_vector == (INDEX_DIM if kind == 'int8'
                                             else INDEX_PQ_M),
                  '%s bytes/vector %d' % (kind, index.bytes_per_vector))
            report[kind] = {'recall': recall, 'build_s': build_s,
                            'bytes_per_vector': index.bytes_per_vector,
                            'latency': tier_latency(index, spans)}
            got_v, got_i = search_all(index, queries[:2])
            want_v, want_i = exact.search(queries[:2], INDEX_K + 1)
            ranked_parity(got_v, got_i, want_v, want_i,
                          '%s full probe + re-rank vs exact' % kind)
    finally:
        quant_lib.train_pq = real_train
    # inserts answer at once; compaction against a fresh build
    index.rerank = quant_lib.DEFAULT_RERANK
    new = index_rows(INDEX_INSERTS, 25)
    t0 = time.perf_counter()
    ids = index.insert(new)
    insert_s = time.perf_counter() - t0
    _v, got = index.search(new[:64], INDEX_K)
    found = float(np.mean([ids[j] == got[j][0] for j in range(64)]))
    check(found == 1.0, 'inserted rows their own nearest: %.3f' % found)
    probe = np.concatenate([queries[:1], new[:1]])
    pre = search_all(index, probe)
    t0 = time.perf_counter()
    compacted = index.compact()
    compact_s = time.perf_counter() - t0
    post = search_all(index, probe)
    fresh = search_all(quant_lib.QuantizedIVFIndex.build(
        store_lib.VectorStore(store.path), kind='pq', pq_m=INDEX_PQ_M,
        device=DEVICE), probe)
    check(compacted == INDEX_INSERTS and all(
        np.array_equal(a, b) for a, b in zip(pre + post, post + fresh)),
          'compaction is not bit for rank with the appended index and a '
          'fresh build')
    del index, exact
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()
    print('index IVF and quantized tiers: %d rows, %d clusters; k-means '
          'builds %s s, two ivf.npz identical; PQ (M=%d) training %s s; '
          'recall@10 at nprobe 8 (re-rank %d): %s; latency (median of 5: '
          'host fill / device by CUDA events / host total): %s; %d inserts '
          'in %.2f s answer at once (each its own nearest), compact() '
          '%.2f s bit for rank with the appended index and a fresh build '
          '[%s]'
          % (n, default_clusters(n), ', '.join('%.2f' % s for s in kmeans_s),
             INDEX_PQ_M,
             ', '.join('%.2f' % s for s in pq_train_s),
             quant_lib.DEFAULT_RERANK,
             ', '.join('%s %.4f (%d B/vector)'
                       % (tier, r['recall'], r['bytes_per_vector'])
                       for tier, r in report.items()),
             '; '.join('%s: %s' % (tier, ', '.join(
                 'b%d %.2f / %.3f / %.2f ms' % (b, v['fill_ms'],
                                                 v['device_ms'], v['host_ms'])
                 for b, v in r['latency'].items()))
                 for tier, r in report.items()),
             INDEX_INSERTS, insert_s, compact_s, gpu))
    return {'tiers': report, 'kmeans_s': kmeans_s, 'pq_train_s': pq_train_s,
            'insert_s': insert_s, 'compact_s': compact_s}


def index_engine_phase(model, index, rng, gpu: str) -> dict:
    """A topk+vectors engine with the exact index attached:
    ``predict_neighbors`` against the index's search of ``predict``'s
    vectors, then LOAD_THREADS caller threads of ``predict_neighbors``
    for INDEX_ENGINE_SECONDS: rows/s, p50/p99, no capture after warm-up,
    no wrapper launch."""
    import threading
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    zero_counts()
    engine = model.serving_engine(tiers=('topk', 'vectors'),
                                  max_delay_ms=2.0)
    try:
        launches = launch_counts()['ragged_fwd']
        engine.attach_index(index)
        lines = make_lines(rng, 8, sizes, model.config.MAX_CONTEXTS)
        got = engine.predict_neighbors(lines, k=INDEX_K, timeout=300)
        want_v, want_i = index.search(np.stack(
            [r.code_vector for r in model.predict(lines, tier='vectors')]),
            INDEX_K)
        check(all(np.array_equal(g.indices, i) and np.array_equal(g.scores, v)
                  for g, v, i in zip(got, want_v, want_i)),
              'predict_neighbors differs from the search of predict\'s '
              'vectors')
        pool = make_lines(rng, 2048, sizes, model.config.MAX_CONTEXTS)
        zero_counts()
        before = engine.stats()
        done, errors = [], []
        lock = threading.Lock()

        def caller(seed):
            r = np.random.default_rng(seed)
            end = time.perf_counter() + INDEX_ENGINE_SECONDS
            mine = []
            try:
                while time.perf_counter() < end:
                    n = int(r.integers(1, 65))
                    start = int(r.integers(0, len(pool) - n))
                    t0 = time.perf_counter()
                    results = engine.predict_neighbors(
                        pool[start:start + n], k=INDEX_K, timeout=300)
                    mine.append((n, time.perf_counter() - t0))
                    check(len(results) == n and all(
                        res.indices[0] >= 0 for res in results),
                          'wrong neighbor results under load')
            except BaseException as exc:
                errors.append(exc)
            with lock:
                done.extend(mine)

        threads = [threading.Thread(target=caller, args=(300 + i,))
                   for i in range(LOAD_THREADS)]
        t0 = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        wall = time.perf_counter() - t0
        check(not errors, 'neighbor load: %r' % errors[:3])
        launched = {k: n for k, n in launch_counts().items() if n}
        # on the CPU (a rehearsal) the engine runs the eager step
        check(not launched or DEVICE != 'cuda', 'kernel wrappers launched '
              'under the neighbor load (no graph replay): %s' % launched)
        after = engine.stats()
        check(after['graph_captures_after_warmup'] == 0,
              'captures after warm-up: %d'
              % after['graph_captures_after_warmup'])
        replays = after['graph_replays'] - before['graph_replays']
        rows = sum(n for n, _s in done)
        lat = sorted(s for _n, s in done)
        report = {'launches': launches, 'replays': replays,
                  'rows_per_s': rows / wall,
                  'p50_ms': 1e3 * lat[len(lat) // 2],
                  'p99_ms': 1e3 * lat[min(len(lat) - 1,
                                          int(0.99 * len(lat)))]}
        print('index engine: topk+vectors engine (%d graphs) with the '
              'exact index attached; predict_neighbors equals the search '
              'of predict\'s vectors; %d threads x %.0f s of '
              'predict_neighbors (1-64 lines, k=%d): %d requests, %.0f '
              'rows/s, p50 %.2f ms p99 %.2f ms, %d graph replays, '
              'captures after warm-up 0, no wrapper launch [%s]'
              % (engine.warm_captures, LOAD_THREADS, INDEX_ENGINE_SECONDS,
                 INDEX_K, len(done), report['rows_per_s'],
                 report['p50_ms'], report['p99_ms'], replays, gpu))
    finally:
        engine.close()
    return report


def index_cli_phase(rng, root: Path, gpu: str) -> dict:
    """``cli.main`` over a 5,000 / 3,000 / 1,000-word vocabulary: train
    and save, ``--build-index`` from a ``.c2v``, then ``--query-neighbors``
    against the built index, whose JSONL equals a direct
    ``query_neighbors_file``. Returns the ragged launches of each."""
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.index import service
    prefix = root / 'cli'
    write_dict(Path(str(prefix) + '.dict.c2v'), 5000, 3000, 1000)
    sizes = (4999, 2999, 999)
    (root / 'cli.train.c2v').write_text(
        '\n'.join(make_lines(rng, 1024, sizes, 200)) + '\n')
    corpus = root / 'corpus.c2v'
    corpus.write_text('\n'.join(make_lines(rng, 3000, sizes, 200)) + '\n')
    query = root / 'query.c2v'
    query.write_text('\n'.join(make_lines(rng, 1500, sizes, 200)) + '\n')
    save = root / 'models' / 'saved_model'
    quiet = ['-v', '0', '--device', DEVICE]
    cli.main(['--data', str(prefix), '--save', str(save), '--epochs', '1']
             + quiet)
    index_dir = root / 'corpus.vecindex'
    zero_counts()
    cli.main(['--load', str(save), '--build-index', str(corpus),
              '--index-path', str(index_dir)] + quiet)
    build = {k: n for k, n in launch_counts().items() if n}
    zero_counts()
    model = cli.main(['--load', str(save), '--index-path', str(index_dir),
                      '--query-neighbors', str(query)] + quiet)
    launched = {k: n for k, n in launch_counts().items() if n}
    size = model.config.TEST_BATCH_SIZE
    check(build == {'ragged_fwd': -(-3000 // size)}
          and launched == {'ragged_fwd': -(-1500 // size)},
          'CLI index launches: build %s, query %s' % (build, launched))
    got = Path(str(query) + '.neighbors.jsonl').read_text().splitlines()
    _n, direct = service.query_neighbors_file(
        model, model.config, corpus_path=str(query),
        output_path=str(root / 'direct.jsonl'))
    check(len(got) == 1500 and Path(direct).read_text().splitlines() == got,
          'CLI --query-neighbors JSONL differs from query_neighbors_file')
    first = json.loads(got[0])
    check(len(first['neighbors']) == INDEX_K and all(
        'label' in n for n in first['neighbors']),
          'CLI neighbors record %r' % first)
    print('index CLI: --build-index from a 3,000-line .c2v (%d ragged '
          'launches), --query-neighbors over 1,500 lines (%d): the JSONL '
          'equals query_neighbors_file\'s [%s]'
          % (build['ragged_fwd'], launched['ragged_fwd'], gpu))
    return {'index_build': build['ragged_fwd'],
            'index_query': launched['ragged_fwd']}


def index_phase(model, gpu: str) -> dict:
    """The embedding index at the code vector's width (D 384), in a
    directory under build/smoke/ that it removes. Returns the ragged
    forward's launches and graph replays on the index paths, and the
    readings."""
    import torch
    root = Path(tempfile.mkdtemp(prefix='index_', dir=SMOKE_DIR))
    started = time.perf_counter()
    try:
        rng = np.random.default_rng(20)
        bulk_store, bulk_launches, bulk_rate = index_bulk_phase(
            model, rng, root, gpu)
        t0 = time.perf_counter()
        rows32 = index_rows(INDEX_ROWS, 11)
        print('index rows: %d x %d float32 from the clustered generator in '
              '%.1f s' % (rows32.shape[0], INDEX_DIM,
                          time.perf_counter() - t0))
        exact, exact_report = index_exact_phase(rows32, bulk_store, root,
                                                gpu)
        ivf_report = index_ivf_phase(rows32, root, gpu)
        del rows32
        engine = index_engine_phase(model, exact, rng, gpu)
        del exact
        if DEVICE == 'cuda':
            torch.cuda.empty_cache()
        cli_counts = index_cli_phase(rng, root, gpu)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print('index phase: %.1f s' % (time.perf_counter() - started))
    return {'launches': {'index_build': bulk_launches
                         + cli_counts['index_build'],
                         'index_query': cli_counts['index_query'],
                         'engine_neighbors': engine['launches']},
            'replays': {'engine_neighbors': engine['replays']},
            'bulk_examples_per_s': bulk_rate, 'exact': exact_report,
            'ivf': ivf_report, 'engine': engine}


# --------------------------------------------------------- the serving mesh
MESH_REPLICAS = 2
MESH_SECONDS = 2.0              # each load run, 8 caller threads
MESH_PLANE_SECONDS = 2.0
MESH_MEMO_BYTES = 64 << 20
MESH_REPEAT = 0.5               # the memo run's share of repeated requests


def permuted_line(line: str, rng) -> str:
    """``line`` with its contexts in another order: the same canonical
    line, so the same memo key."""
    label, *contexts = line.split(' ')
    order = rng.permutation(len(contexts))
    return ' '.join([label] + [contexts[i] for i in order])


def mesh_replica_bytes(mesh) -> list:
    """Each replica's ``(id, parameter-slot bytes, graph-pool bytes)`` from
    the memory ledger's entries under its engine's key."""
    from code2vec_tpu_torch.telemetry import memory as memory_lib
    buckets = memory_lib.ledger().snapshot(reconcile=False)['buckets']
    out = []
    for slot in mesh._replicas:
        prefix = slot.transport.engine._mem_prefix + '/'
        slots, pool = (sum(e['bytes'] for e in buckets[name]['entries']
                           if e['key'].startswith(prefix))
                       for name in ('params', 'executables'))
        out.append((slot.rid, slots, pool))
    return out


def mesh_warm(mesh, gpu: str, tag: str) -> dict:
    """Check and print one warmed mesh: each replica's captures (its own
    ladder: keys x slots), none after warm-up, its slot and pool bytes."""
    stats = mesh.replica_stats()
    keys = len(mesh._replicas[0].transport.engine.ladder.keys())
    for replica in stats:
        slots = replica['ladder']['warm_slots']
        check(replica['graph_captures'] == keys * slots
              and replica['graph_captures_after_warmup'] == 0,
              'mesh %s: replica %s captured %d graphs for %d keys x %d '
              'slots' % (tag, replica['replica'], replica['graph_captures'],
                         keys, slots))
    ledger = mesh_replica_bytes(mesh)
    print('mesh warm-up (%s, %s wire): %d replicas, each its own ladder of '
          '%d keys x %d slots: captures %s in %s s, captures after warm-up '
          '0; ledger per replica (slots bytes, graph pool bytes): %s [%s]'
          % (tag, mesh._replicas[0].transport.engine.wire, len(stats), keys,
             stats[0]['ladder']['warm_slots'],
             [r['graph_captures'] for r in stats],
             ['%.2f' % r['warmup_s'] for r in stats],
             {rid: (slots, pool) for rid, slots, pool in ledger}, gpu))
    return {'keys': keys, 'captures': [r['graph_captures'] for r in stats],
            'warm_s': [r['warmup_s'] for r in stats], 'ledger': ledger}


def mesh_replays(mesh) -> dict:
    """Graph replays per key name of every replica, by replica id: a
    thread replica's from its ladder (retired and closed ones too: a
    ladder keeps its counts), a live worker's from its stats over the
    wire (a dead or retired worker's are gone with its process)."""
    from code2vec_tpu_torch.serving.graphs import key_name
    out = {}
    for slot in mesh._replicas:
        engine = getattr(slot.transport, 'engine', None)
        if engine is not None:
            out[slot.rid] = {key_name(k): n for k, n
                             in engine.ladder.counts()[1].items()}
        elif not (slot.dead or slot.retired):
            out[slot.rid] = dict(slot.transport.stats()['ladder']['replays'])
    return out


def total_replays(mesh) -> int:
    return sum(sum(counts.values()) for counts in mesh_replays(mesh).values())


def replay_key(name: str):
    """``'b64/c1024/topk/s1'`` -> the slot-0 ``GraphKey`` of its (bucket,
    rung, tier): a replay's device time is the same in either slot."""
    from code2vec_tpu_torch.serving.graphs import GraphKey
    bucket, rung, tier, _slot = name.split('/')
    return GraphKey(int(bucket[1:]), int(rung[1:]), tier, 0)


def mesh_load(mesh, pool_lines, mix, seconds: float, gpu: str, tag: str,
              ms_cache: dict, repeat: float = 0.0, timer=None) -> dict:
    """LOAD_THREADS caller threads through ``mesh.submit`` for ``seconds``:
    requests of 1-64 lines from ``pool_lines`` at tiers from ``mix``;
    with ``repeat``, that share of the requests repeats an earlier one
    with its contexts permuted (the permuted lines made before the timed
    window; after it, every answer served at submit must equal the first
    one's bit for bit). Rows/s live and cached, client p50/p99,
    rows and mean fill per replica, the card's idle share (1 - the
    replays' device ms, summed over the replicas' streams, over the
    wall; a worker mesh's replays are timed on ``timer``, a thread
    replica's ladder of the same keys), and the interpreter's garbage
    collections in the window (all threads wait while one runs). No
    wrapper may launch and nothing may be captured."""
    import gc
    import threading
    zero_counts()
    before = mesh.stats()
    rows0 = {r['replica']: r['rows_dispatched'] for r in before['replicas']}
    replays0 = mesh_replays(mesh)
    permuted = ([permuted_line(line, np.random.default_rng(i))
                 for i, line in enumerate(pool_lines)] if repeat else None)
    done, errors, sent, answers = [], [], [], []
    lock = threading.Lock()

    def caller(seed):
        r = np.random.default_rng(seed)
        end = time.perf_counter() + seconds
        mine = []
        try:
            while time.perf_counter() < end:
                earlier = None
                if repeat and r.random() < repeat:
                    with lock:
                        if sent:
                            earlier = sent[int(r.integers(len(sent)))]
                if earlier is not None:
                    start, n, tier, want = earlier
                    lines = permuted[start:start + n]
                else:
                    n = int(r.integers(1, 65))
                    start = int(r.integers(0, len(pool_lines) - n))
                    tier = mix[int(r.integers(len(mix)))]
                    lines = pool_lines[start:start + n]
                t0 = time.perf_counter()
                future = mesh.submit(lines, tier=tier)
                cached = future.done()
                results = future.result(timeout=300)
                mine.append((n, tier, time.perf_counter() - t0, cached))
                check(len(results) == n, 'wrong result count under load')
                if earlier is not None and cached:
                    with lock:
                        answers.append((results, want))
                if repeat and earlier is None:
                    with lock:
                        sent.append((start, n, tier, results))
        except BaseException as exc:
            errors.append(exc)
        with lock:
            done.extend(mine)

    collections, gc_start = [], [0.0]

    def on_gc(phase, info):
        if phase == 'start':
            gc_start[0] = time.perf_counter()
        else:
            collections.append((info['generation'],
                                time.perf_counter() - gc_start[0]))

    threads = [threading.Thread(target=caller, args=(200 + i,))
               for i in range(LOAD_THREADS)]
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    check(not errors, 'mesh load: %r' % errors[:3])
    for results, want in answers:
        check(result_diff(results, want, 'memo hit') == 0,
              'an answer served from the memo differs from the live one')
    launched = {k: n for k, n in launch_counts().items() if n}
    check(not launched, 'kernel wrappers launched under mesh load (no graph '
          'replay): %s' % launched)
    after = mesh.stats()
    replays = mesh_replays(mesh)
    if timer is None:
        timer = next(s.transport.engine.ladder for s in mesh._replicas
                     if not s.retired)
    per_replica, device_ms = {}, 0.0
    for rid, counts in replays.items():
        delta = {k: n - replays0.get(rid, {}).get(k, 0)
                 for k, n in counts.items()
                 if n > replays0.get(rid, {}).get(k, 0)}
        keys = {name: replay_key(name) for name in delta}
        for key in keys.values():
            if key not in ms_cache:
                ms_cache[key] = timer.replay_ms(key)
        rows = next(r['rows_dispatched'] for r in after['replicas']
                    if r['replica'] == rid) - rows0.get(rid, 0)
        padded = sum(n * keys[name].bucket for name, n in delta.items())
        per_replica[rid] = {'rows': rows, 'fill': rows / max(padded, 1),
                            'replays': sum(delta.values())}
        device_ms += sum(n * ms_cache[keys[name]]
                         for name, n in delta.items())
    for replica in mesh.replica_stats():
        check(replica.get('graph_captures_after_warmup', 0) == 0,
              'mesh: captures after warm-up on %s' % replica['replica'])
    lat = sorted(d[2] for d in done)
    cached_rows = sum(d[0] for d in done if d[3])
    live_rows = sum(d[0] for d in done if not d[3])
    report = {'requests': len(done), 'seconds': wall,
              'rows_per_s': (live_rows + cached_rows) / wall,
              'live_rows_per_s': live_rows / wall,
              'cached_rows_per_s': cached_rows / wall,
              'p50_ms': 1e3 * lat[len(lat) // 2],
              'p99_ms': 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
              'replicas': per_replica, 'device_ms': device_ms,
              'idle': 1 - device_ms / (1e3 * wall),
              'gc_s': sum(p for _g, p in collections),
              'gc_gen2': sum(1 for g, _p in collections if g == 2),
              'gc_max_ms': 1e3 * max([p for _g, p in collections] or [0])}
    memo = after['memo']
    if memo is not None:
        hits = memo['hits'] - before['memo']['hits']
        misses = memo['misses'] - before['memo']['misses']
        report['memo_hit_share'] = hits / max(hits + misses, 1)
    print('mesh load (%s, %d threads x %.0f s, tiers %s): %d requests, '
          '%.0f rows/s (live %.0f, from the memo %.0f), client latency '
          'p50 %.2f ms p99 %.2f ms; per replica rows and mean fill %s; '
          'device %.1f ms summed over the replicas\' streams in %.2f s '
          'wall: idle %.1f%%; garbage collections %d (%d of generation '
          '2) took %.3f s, the longest %.1f ms; %s no capture after '
          'warm-up, no wrapper '
          'launch%s [%s]'
          % (tag, LOAD_THREADS, seconds, list(mix), len(done),
             report['rows_per_s'], report['live_rows_per_s'],
             report['cached_rows_per_s'], report['p50_ms'],
             report['p99_ms'],
             {rid: (v['rows'], round(v['fill'], 3))
              for rid, v in per_replica.items()},
             device_ms, wall, 100 * report['idle'], len(collections),
             report['gc_gen2'], report['gc_s'], report['gc_max_ms'],
             ('memo hit share %.3f;' % report['memo_hit_share']
              if 'memo_hit_share' in report else ''),
             ('; %d answers from the memo equal to the live ones bit for '
              'bit' % len(answers) if repeat else ''), gpu))
    return report


class MeshTraffic:
    """``threads`` caller threads of topk requests through a mesh until
    ``stop()``: every request must return its rows."""

    def __init__(self, mesh, pool_lines, threads: int = 4):
        import threading
        self.mesh, self.pool = mesh, pool_lines
        self.served = 0
        self.errors = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(300 + i,))
                         for i in range(threads)]
        for thread in self._threads:
            thread.start()

    def _run(self, seed):
        r = np.random.default_rng(seed)
        try:
            while not self._stop.is_set():
                n = int(r.integers(1, 33))
                start = int(r.integers(0, len(self.pool) - n))
                results = self.mesh.predict(self.pool[start:start + n],
                                            tier='topk', timeout=300)
                check(len(results) == n, 'traffic: wrong result count')
                with self._lock:
                    self.served += 1
        except BaseException as exc:
            self.errors.append(exc)

    def stop(self) -> int:
        self._stop.set()
        for thread in self._threads:
            thread.join()
        check(not self.errors, 'traffic: %r' % self.errors[:3])
        return self.served


def mesh_parity(mesh, model, rng, sizes, gpu: str, tag: str) -> None:
    """Requests alone through the mesh against ``Code2VecModel.predict``
    at buckets 8 and 64, tiers topk and attention: bit for bit."""
    cases = 0
    for n in (5, 50):
        lines = make_lines(rng, n, sizes, model.config.MAX_CONTEXTS)
        for tier in ('topk', 'attention'):
            diff = result_diff(mesh.predict(lines, tier=tier, timeout=300),
                               model.predict(lines, tier=tier),
                               'mesh vs predict')
            check(diff == 0, 'mesh %s vs predict (%d lines, %s): max |diff| '
                  '%.3g' % (tag, n, tier, diff))
            cases += 1
    print('mesh parity (%s): %d cases (buckets 8, 64 x topk, attention) bit '
          'for bit equal to Code2VecModel.predict [%s]' % (tag, cases, gpu))


def mesh_phase(model, planes, gpu: str) -> dict:
    """The serving mesh in thread mode at java14m width (bf16, packed
    wire, the default ladder): 2 replicas against 1 in the order A B B A,
    mixed tiers, the memo with repeats, a coordinated swap and a rollback
    under traffic, a retirement under traffic, a draining close, then a
    short plane-wire mesh. Returns the ragged forward's and the encode
    kernel's wrapper launches in the meshes' warm-ups and their graph
    replays."""
    import copy
    import dataclasses
    import torch
    from code2vec_tpu_torch.model_api import ServingParamSource
    from code2vec_tpu_torch.models.functional import Code2VecParams
    started = time.perf_counter()
    rng = np.random.default_rng(30)
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    pool_lines = make_lines(rng, 4096, sizes, model.config.MAX_CONTEXTS)
    ckpt_dir = SMOKE_DIR / 'mesh_checkpoints'
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    store = model._store_for(str(ckpt_dir / 'model'))
    names = Code2VecParams._fields
    for step in (0, 1):    # step 1: the same weights at a bumped step
        store.save_training(params=dict(zip(names, model.backend.params)),
                            opt_state={}, step=step, epoch=0)
    source = ServingParamSource(model, store)
    common = dict(param_source=source, params_step=0, max_delay_ms=2.0)
    launches = replays = 0
    ms_cache = {}
    try:
        zero_counts()
        mesh_a = model.serving_mesh(replicas=MESH_REPLICAS, **common)
        mesh_b = model.serving_mesh(replicas=1, **common)
        warm_a = mesh_warm(mesh_a, gpu, '%d replicas' % MESH_REPLICAS)
        warm_b = mesh_warm(mesh_b, gpu, '1 replica')
        launches += launch_counts()['ragged_fwd']
        check(launches == 3 * warm_a['keys'] * (MESH_REPLICAS + 1),
              'mesh warm-ups: the ragged forward\'s wrapper ran %d times for '
              '%d keys x %d replicas' % (launches, warm_a['keys'],
                                         MESH_REPLICAS + 1))
        try:
            mesh_parity(mesh_a, model, rng, sizes, gpu, 'A')
            runs = {'A': [], 'B': []}
            for tag in 'ABBA':
                mesh = mesh_a if tag == 'A' else mesh_b
                runs[tag].append(mesh_load(
                    mesh, pool_lines, ('topk',), MESH_SECONDS, gpu,
                    'topk, %s: %d replica(s)' % (tag, len(mesh._replicas)),
                    ms_cache))
            mixed = mesh_load(mesh_a, pool_lines, ENGINE_TIERS, MESH_SECONDS,
                              gpu, 'mixed tiers, A', ms_cache)
            rates = {tag: [r['rows_per_s'] for r in reports]
                     for tag, reports in runs.items()}
            print('mesh A B B A (topk rows/s): A %s, B %s; A/B %.3f [%s]'
                  % (['%.0f' % x for x in rates['A']],
                     ['%.0f' % x for x in rates['B']],
                     sum(rates['A']) / sum(rates['B']), gpu))
        finally:
            mesh_a.close()
            mesh_b.close()
        replays += total_replays(mesh_a) + total_replays(mesh_b)
        del mesh_a, mesh_b
        torch.cuda.empty_cache()

        # the memo, the SLO monitor, rollover, retirement and drain on a
        # mesh of their own
        slo_model = copy.copy(model)
        slo_model.config = dataclasses.replace(
            model.config, SERVING_SLO_AVAILABILITY=0.99,
            SERVING_SLO_P99_MS=250.0)
        zero_counts()
        mesh = slo_model.serving_mesh(replicas=MESH_REPLICAS,
                                      memo_cache_bytes=MESH_MEMO_BYTES,
                                      **common)
        warm_m = mesh_warm(mesh, gpu, 'memo and SLO')
        launches += launch_counts()['ragged_fwd']
        try:
            memo = mesh_load(mesh, pool_lines, ('topk',), MESH_SECONDS, gpu,
                             'topk, memo on, %.0f%% repeats permuted'
                             % (100 * MESH_REPEAT), ms_cache,
                             repeat=MESH_REPEAT)
            check(memo['memo_hit_share'] > 0, 'mesh: no memo hit')
            generation = mesh.stats()['memo']['generation']
            # a coordinated swap to a checkpoint of a bumped step, under
            # traffic
            traffic = MeshTraffic(mesh, pool_lines)
            t0 = time.perf_counter()
            swap = mesh.load_params(1).result(timeout=300)
            swap_s = time.perf_counter() - t0
            steps = [r['params_step'] for r in mesh.replica_stats()]
            slots = [r['serving_slot'] for r in mesh.replica_stats()]
            check(swap['swapped'] and swap['replicas_swapped']
                  == MESH_REPLICAS and steps == [1] * MESH_REPLICAS
                  and slots == [1] * MESH_REPLICAS,
                  'mesh swap: %r, steps %s, slots %s' % (swap, steps, slots))
            memo_after = mesh.stats()['memo']
            check(memo_after['generation'] == generation + 1
                  and memo_after['entries'] == 0,
                  'mesh swap: memo %r' % memo_after)
            # a rollback: a candidate whose target rows are permuted
            params = model.backend.params
            gen = torch.Generator().manual_seed(5)
            perm = torch.randperm(params.target_embedding.shape[0],
                                  generator=gen).to(params.target_embedding
                                                    .device)
            candidate = params._replace(
                target_embedding=params.target_embedding[perm])
            t0 = time.perf_counter()
            back = mesh.load_params(candidate).result(timeout=300)
            back_s = time.perf_counter() - t0
            del candidate, perm
            steps = [r['params_step'] for r in mesh.replica_stats()]
            check(not back['swapped'] and back['replicas_swapped'] == 0
                  and steps == [1] * MESH_REPLICAS
                  and [r['serving_slot'] for r in mesh.replica_stats()]
                  == slots,
                  'mesh rollback: %r, steps %s' % (back, steps))
            served = traffic.stop()
            captures = [r['graph_captures_after_warmup']
                        for r in mesh.replica_stats()]
            check(captures == [0] * MESH_REPLICAS,
                  'mesh rollover: captures after warm-up %s' % captures)
            print('mesh rollover under traffic (%d requests served, none '
                  'failed): load_params(step 1) swapped in %.2f s at '
                  'agreement %.3f on canary %s, %d replicas on step 1, memo '
                  'generation %d -> %d (entries 0); permuted target rows '
                  'rolled back in %.2f s at agreement %.3f, every replica '
                  'still on step 1; captures after warm-up %s [%s]'
                  % (served, swap_s, swap['agreement'],
                     swap['canary_replica'], swap['replicas_swapped'],
                     generation, memo_after['generation'], back_s,
                     back['agreement'], captures, gpu))
            # retire r1 under traffic: it stops pulling, nothing is lost
            traffic = MeshTraffic(mesh, pool_lines)
            time.sleep(0.5)
            t0 = time.perf_counter()
            mesh.retire('r1')
            retire_s = time.perf_counter() - t0
            frozen = mesh.stats()['replicas'][1]['batches']
            r0 = mesh.stats()['replicas'][0]['batches']
            time.sleep(1.0)
            served = traffic.stop()
            rows = mesh.stats()['replicas']
            check(rows[1]['retired'] and rows[1]['batches'] == frozen
                  and rows[0]['batches'] > r0,
                  'mesh retire: %r' % rows)
            print('mesh retire(\'r1\') under traffic: drained in %.2f s, r1 '
                  'stopped at %d batches, r0 went on (%d -> %d), %d requests '
                  'served, none failed [%s]'
                  % (retire_s, frozen, r0, rows[0]['batches'], served, gpu))
            # close(drain=True) serves what waits in the coalescing window
            lines = tile_lines(rng, 8, sizes)
            want = [mesh.predict([line], tier='topk', timeout=300)
                    for line in lines]
            slo = mesh.stats()['slo']
            mesh.max_delay_s = 30.0
            futures = [mesh.submit([line], tier='topk') for line in lines]
        finally:
            mesh.close(drain=True)
        replays += total_replays(mesh)
        for future, expected in zip(futures, want):
            check(result_diff(future.result(timeout=60), expected,
                              'drain') == 0,
                  'mesh close(drain=True): a result differs')
        print('mesh close(drain=True): %d parked requests served bit for '
              'bit; SLO (availability 0.99, p99 250 ms): %d alerts, good '
              '%d, bad %d, slow %d, availability burn fast %.3f [%s]'
              % (len(lines), slo['alerts_total'], slo['good_total'],
                 slo['bad_total'], slo['slow_total'],
                 slo['availability_burn_fast'], gpu))
        del mesh
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # the plane wire: every replica's graphs hold the encode kernel
    zero_counts()
    plane_mesh = planes.serving_mesh(replicas=MESH_REPLICAS, max_delay_ms=2.0)
    try:
        warm_p = mesh_warm(plane_mesh, gpu, 'plane wire')
        plane_launches = launch_counts()['encode']
        check(plane_launches == 2 * warm_p['keys'] * MESH_REPLICAS,
              'plane mesh warm-up: %d encode launches for %d keys x %d '
              'replicas' % (plane_launches, warm_p['keys'], MESH_REPLICAS))
        mesh_parity(plane_mesh, planes, rng, sizes, gpu, 'plane wire')
        plane = mesh_load(plane_mesh, pool_lines, ('topk',),
                          MESH_PLANE_SECONDS, gpu, 'plane wire, topk', {})
    finally:
        plane_mesh.close()
    plane_replays = total_replays(plane_mesh)
    del plane_mesh
    torch.cuda.empty_cache()
    print('mesh phase: %.1f s' % (time.perf_counter() - started))
    return {'launches': launches, 'replays': replays,
            'plane_launches': plane_launches, 'plane_replays': plane_replays,
            'runs': runs, 'mixed': mixed, 'memo': memo, 'plane': plane,
            'warm': (warm_a, warm_b, warm_m, warm_p)}


MESH_WORKERS = 2
MESH_WORKER_SECONDS = 2.0       # each load run, 8 caller threads
MESH_MEMORY_SLACK = 1 << 30     # the card's used bytes after the workers
MESH_RESTART_BACKOFF = 10.0     # the kill drill's wait before the restart


def card_used_bytes() -> int:
    """Bytes in use on the card by every process (``mem_get_info``),
    after this process collects its garbage (a closed mesh's engines sit
    in reference cycles with it) and returns its cached blocks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return total - free


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open('/proc/%d/stat' % pid) as f:
            return f.read().split(') ')[1].split()[0] != 'Z'
    except OSError:
        return False


def worker_rows(mesh, kernel: str, gpu: str, tag: str) -> list:
    """Each worker's stats over the wire: its own ladder (captures =
    keys x slots, none after warm-up), its kernel wrapper's launches in
    its warm-up (one run and one capture a slot, per key), its memory."""
    rows = mesh.replica_stats()
    for row in rows:
        ladder = row['ladder']
        keys = ladder['graphs'] // ladder['warm_slots']
        launches = row['kernel_launches'][kernel]
        check(row['graph_captures'] == ladder['graphs']
              and row['graph_captures_after_warmup'] == 0
              and launches == keys * (1 + ladder['warm_slots']),
              'mesh %s: worker %s captured %d of %d graphs, %d after '
              'warm-up, %d %s launches for %d keys'
              % (tag, row['replica'], row['graph_captures'],
                 ladder['graphs'], row['graph_captures_after_warmup'],
                 launches, kernel, keys))
    print('mesh workers (%s): %s [%s]' % (tag, [
        {'replica': r['replica'], 'pid': r['pid'],
         'params_step': r['params_step'], 'warm_s': round(r['warmup_s'], 2),
         'graphs': r['ladder']['graphs'],
         '%s_launches' % kernel: r['kernel_launches'][kernel],
         'memory': r['device_memory']} for r in rows], gpu))
    return rows


def build_meshes(builders: dict) -> dict:
    """Build meshes together, one thread each, so their workers
    cold-start at once: ``{name: (mesh, seconds to ready)}``. A failure
    closes every mesh built and raises."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(build):
        t0 = time.perf_counter()
        mesh = build()
        return mesh, time.perf_counter() - t0

    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {name: pool.submit(timed, build)
                   for name, build in builders.items()}
    built, errors = {}, []
    for name, future in futures.items():
        try:
            built[name] = future.result()
        except BaseException as exc:
            errors.append('%s: %r' % (name, exc))
    if errors:
        for mesh, _s in built.values():
            mesh.close()
        check(False, 'mesh workers did not start: %s' % errors)
    return built


def load_summary(reports: list) -> str:
    return 'rows/s %s p99 ms %s idle %% %s' % tuple(
        ['%.1f' % (100 * r[key] if key == 'idle' else r[key])
         for r in reports] for key in ('rows_per_s', 'p99_ms', 'idle'))


def mesh_worker_phase(model, planes, gpu: str) -> dict:
    """The serving mesh's worker modes at java14m width (bf16, the default
    ladder): the model saved once; 2 process replicas (each a spawned
    process of the port: its own CUDA context, model and ladder of graphs
    holding the ragged forward), 1 socket replica and 1 plane-wire
    process replica (the encode kernel), started together, each against
    ``predict`` bit for bit; topk load through 2 process replicas, 2
    thread replicas and 1 replica, run A B C C B A; a worker SIGKILLed
    under traffic while the fleet rolls to a newly saved step (every
    request answered, the restart adopting that step); every worker gone
    after ``close()`` and the card's used memory back. Returns the
    workers' kernel launches (their warm-ups) and graph replays."""
    import copy
    import dataclasses
    import signal
    import torch
    from code2vec_tpu_torch.models.functional import Code2VecParams
    started = time.perf_counter()
    rng = np.random.default_rng(31)
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    pool_lines = make_lines(rng, 4096, sizes, model.config.MAX_CONTEXTS)
    root = SMOKE_DIR / 'mesh_workers'
    shutil.rmtree(root, ignore_errors=True)
    # the workers restore the weights from a checkpoint of the model
    path = str(root / 'model')
    saved = copy.copy(model)
    saved.config = dataclasses.replace(model.config, MODEL_SAVE_PATH=path)
    planes_saved = copy.copy(planes)
    planes_saved.config = dataclasses.replace(planes.config,
                                              MODEL_LOAD_PATH=path)
    state = model.trainer.state_from_params()
    t0 = time.perf_counter()
    saved.save(epoch=0, state=state)
    save_s = time.perf_counter() - t0
    del state
    used0 = card_used_bytes()
    reserved0 = torch.cuda.memory_reserved()
    print('mesh workers: java14m model saved at step 0 in %.2f s; the card '
          'holds %d bytes before any worker, this process reserves %d [%s]'
          % (save_s, used0, reserved0, gpu))
    store = saved._store_for(path)
    names = Code2VecParams._fields
    launches = replays = 0
    pids = []
    ms_cache = {}
    proc = None
    try:
        # the restart waits out its backoff: the kill drill rolls the
        # fleet and saves a newer step meanwhile
        built = build_meshes({
            'process': lambda: saved.serving_mesh(
                replicas=MESH_WORKERS, mode='process', max_delay_ms=2.0,
                restart_backoff_secs=MESH_RESTART_BACKOFF),
            'socket': lambda: saved.serving_mesh(
                replicas=1, mode='socket', max_delay_ms=2.0),
            'planes': lambda: planes_saved.serving_mesh(
                replicas=1, mode='process', max_delay_ms=2.0)})
        proc, sock, plane = (built[name][0]
                             for name in ('process', 'socket', 'planes'))
        for mesh in (proc, sock, plane):
            pids += [r['pid'] for r in mesh.stats()['replicas']]
        used1 = card_used_bytes()
        print('mesh workers: %d process, 1 socket and 1 plane-wire process '
              'replica started together, ready in %s s; the card +%d '
              'bytes, %d a worker [%s]'
              % (MESH_WORKERS, {name: round(sec, 1) for name, (_m, sec)
                                in built.items()},
                 used1 - used0, (used1 - used0) // len(pids), gpu))
        try:
            for mesh, kernel, reference, tag in (
                    (proc, 'ragged_fwd', model, 'process workers'),
                    (sock, 'ragged_fwd', model, 'socket worker'),
                    (plane, 'encode', planes, 'plane-wire worker')):
                rows = worker_rows(mesh, kernel, gpu, tag)
                mesh_parity(mesh, reference, rng, sizes, gpu, tag)
                if mesh is plane:
                    plane_launches = rows[0]['kernel_launches']['encode']
                    plane_replays = total_replays(plane)
                else:
                    launches += sum(r['kernel_launches']['ragged_fwd']
                                    for r in rows)
            replays += total_replays(sock)
        finally:
            sock.close()
            plane.close()

        # topk load: 2 process replicas (A), 2 thread replicas (B), 1
        # replica (C), run A B C C B A after an untimed second of traffic
        # through each (a worker's first requests build its host paths)
        thread2 = model.serving_mesh(replicas=MESH_WORKERS, max_delay_ms=2.0)
        one = model.serving_mesh(replicas=1, max_delay_ms=2.0)
        timer = thread2._replicas[0].transport.engine.ladder
        runs = {'A': [], 'B': [], 'C': []}
        try:
            for mesh in (proc, thread2, one):
                traffic = MeshTraffic(mesh, pool_lines, threads=LOAD_THREADS)
                time.sleep(1.0)
                traffic.stop()
            for tag in 'ABCCBA':
                mesh = {'A': proc, 'B': thread2, 'C': one}[tag]
                runs[tag].append(mesh_load(
                    mesh, pool_lines, ('topk',), MESH_WORKER_SECONDS, gpu,
                    'topk, %s: %d %s replica(s)'
                    % (tag, len(mesh._replicas), mesh.mode), ms_cache,
                    timer=timer))
        finally:
            thread2.close()
            one.close()
        del thread2, one, timer
        used_threads = card_used_bytes()
        print('mesh workers: after the thread meshes closed, this process '
              'reserves %+d bytes from before the workers, the card %+d '
              '[%s]' % (torch.cuda.memory_reserved() - reserved0,
                        used_threads - used0, gpu))
        rates = {tag: sum(r['rows_per_s'] for r in reports)
                 for tag, reports in runs.items()}
        print('mesh workers A B C C B A (topk, %d threads x %.0f s): A = %d '
              'process replicas %s; B = %d thread replicas %s; C = 1 '
              'replica %s; A/B %.3f, A/C %.3f [%s]'
              % (LOAD_THREADS, MESH_WORKER_SECONDS, MESH_WORKERS,
                 load_summary(runs['A']), MESH_WORKERS,
                 load_summary(runs['B']), load_summary(runs['C']),
                 rates['A'] / rates['B'], rates['A'] / rates['C'], gpu))

        # the kill drill: SIGKILL r0 mid-batch under traffic; while it is
        # down the fleet rolls to a newly saved step 1, then step 2 is
        # saved, so the restarted r0 cold-starts at 2 and must adopt the
        # fleet's 1 before it pulls
        slot0 = proc._replicas[0]
        first_pid = slot0.transport.pid
        # r0's replays die with it
        replays += sum(mesh_replays(proc)['r0'].values())
        traffic = MeshTraffic(proc, pool_lines)
        deadline = time.perf_counter() + 30.0
        while slot0.inflight < 1:
            check(time.perf_counter() < deadline, 'r0 held no batch')
            time.sleep(0.001)
        os.kill(first_pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        while not slot0.dead:   # the receiver's EOF: the death verdict
            check(time.perf_counter() - t_kill < 30, 'r0 not declared dead')
            time.sleep(0.001)
        t_dead = time.perf_counter()
        params = dict(zip(names, model.backend.params))
        store.save_training(params=params, opt_state={}, step=1, epoch=0)
        swap = proc.load_params(1, canary_batches=0).result(timeout=300)
        t_swap = time.perf_counter()
        store.save_training(params=params, opt_state={}, step=2, epoch=0)
        t_saved = time.perf_counter()
        del params
        check(swap['swapped'] and (slot0.dead or slot0.restarting)
              and t_saved - t_kill < MESH_RESTART_BACKOFF,
              'kill drill: the swap %r and the saves ended %.1f s after the '
              'kill, r0 dead %s' % (swap, t_saved - t_kill, slot0.dead))
        while not (proc.stats()['restarts_total'] >= 1 and not slot0.dead):
            check(time.perf_counter() - t_kill < 300,
                  'r0 did not rejoin within 300 s')
            time.sleep(0.05)
        t_rejoin = time.perf_counter()
        time.sleep(1.0)   # the rejoined r0 serves traffic too
        served = traffic.stop()
        stats = proc.stats()
        rows = worker_rows(proc, 'ragged_fwd', gpu, 'process, after the '
                           'kill drill')
        launches += rows[0]['kernel_launches']['ragged_fwd']
        pids += [slot0.transport.pid]
        cold_step = slot0.transport.ready_info.get('params_step')
        check(stats['redispatched_total'] >= 1 and cold_step == 2
              and [r['params_step'] for r in rows] == [1] * MESH_WORKERS
              and stats['params_step'] == 1
              and stats['replicas_live'] == MESH_WORKERS
              and stats['replicas'][0]['batches'] > 0,
              'kill drill: cold start at %s, %r' % (cold_step, {
                  k: stats[k] for k in ('redispatched_total',
                                        'restarts_total', 'params_step',
                                        'replicas_live', 'replicas')}))
        print('mesh kill drill (process, 4 caller threads): r0 (pid %d) '
              'SIGKILLed mid-batch, declared dead %.3f s later; %d '
              'requests answered, none lost or failed; %d redispatched; '
              'the fleet swapped to step 1 %.2f s '
              'after the kill (the save and the restore included), step 2 '
              'saved; r0 came up as pid %d at step %s and adopted step %d, '
              'rejoining %.2f s after the kill (%.0f s backoff, then %.2f s '
              'of cold start and adoption); batches per replica %s [%s]'
              % (first_pid, t_dead - t_kill, served,
                 stats['redispatched_total'],
                 t_swap - t_kill, slot0.transport.pid, cold_step,
                 rows[0]['params_step'], t_rejoin - t_kill,
                 MESH_RESTART_BACKOFF,
                 t_rejoin - t_kill - MESH_RESTART_BACKOFF,
                 [r['batches'] for r in stats['replicas']], gpu))
        replays += total_replays(proc)
    finally:
        if proc is not None:
            proc.close()
    torch.cuda.empty_cache()

    shutil.rmtree(root, ignore_errors=True)
    alive = [pid for pid in pids if pid_alive(pid)]
    # what the workers held: the card's used bytes less this process's
    # own growth (an exited process's memory returns to the card a little
    # after the exit)
    t0 = time.perf_counter()
    while True:
        used_end = card_used_bytes()
        reserved_end = torch.cuda.memory_reserved()
        left = (used_end - used0) - (reserved_end - reserved0)
        if left <= MESH_MEMORY_SLACK or time.perf_counter() - t0 > 20.0:
            break
        time.sleep(0.5)
    check(not alive and left <= MESH_MEMORY_SLACK,
          'mesh workers after close(): pids alive %s, the card %+d bytes '
          'from before the workers, %+d of them this process\'s'
          % (alive, used_end - used0, reserved_end - reserved0))
    print('mesh workers closed: %d worker pids, none alive; the card %+d '
          'bytes from before the workers after %.1f s, this process '
          'reserving %+d of them: the workers left %+d (slack %d) [%s]'
          % (len(pids), used_end - used0, time.perf_counter() - t0,
             reserved_end - reserved0, left, MESH_MEMORY_SLACK, gpu))
    print('mesh worker phase: %.1f s' % (time.perf_counter() - started))
    return {'launches': launches, 'replays': replays,
            'plane_launches': plane_launches, 'plane_replays': plane_replays,
            'runs': runs}


MESH_ELASTIC_REQUESTS = 12      # 1024-line requests a wave: 12,288 rows
MESH_ELASTIC_IDLE = 1.0         # AUTOSCALE_DOWN_IDLE_SECS
#: the autoscaler driven by tick(): a long interval, a short up-queue
#: threshold, no cooldowns
MESH_ELASTIC_KNOBS = dict(
    AUTOSCALE_MAX_REPLICAS=2, AUTOSCALE_MIN_REPLICAS=1,
    AUTOSCALE_INTERVAL_SECS=3600.0, AUTOSCALE_UP_QUEUE_SECS=0.05,
    AUTOSCALE_UP_COOLDOWN_SECS=0.0, AUTOSCALE_DOWN_COOLDOWN_SECS=0.0,
    AUTOSCALE_DOWN_IDLE_SECS=MESH_ELASTIC_IDLE,
    AUTOSCALE_DOWN_UTILIZATION=0.9, AUTOSCALE_FLAP_LIMIT=10,
    # every worker stalls its first 64 batches 250 ms: a real backlog,
    # and a kill that lands mid-batch
    FAULT_INJECT='slow_dispatch@req=0..63')


def wait_for(predicate, seconds: float, what: str,
             phase: str = 'mesh elastic') -> float:
    """Poll until ``predicate()``; the time it took. Fails after
    ``seconds``."""
    t0 = time.perf_counter()
    while not predicate():
        check(time.perf_counter() - t0 < seconds,
              '%s: %s not within %.0f s' % (phase, what, seconds))
        time.sleep(0.01)
    return time.perf_counter() - t0


def elastic_worker(mesh, rid: str, gpu: str) -> dict:
    """One live worker's stats over the wire: its own ladder, captured at
    its warm-up and never after, its ragged forward's launches (a run
    and a capture a slot, per key)."""
    slot = next(s for s in mesh._replicas if s.rid == rid)
    row = slot.transport.stats()
    ladder = row['ladder']
    keys = ladder['graphs'] // ladder['warm_slots']
    launches = row['kernel_launches']['ragged_fwd']
    check(row['graph_captures'] == ladder['graphs']
          and row['graph_captures_after_warmup'] == 0
          and launches == keys * (1 + ladder['warm_slots']),
          'mesh elastic: worker %s captured %d of %d graphs, %d after '
          'warm-up, %d ragged launches for %d keys'
          % (rid, row['graph_captures'], ladder['graphs'],
             row['graph_captures_after_warmup'], launches, keys))
    print('mesh elastic: worker %s (pid %s, step %s): %d graphs warmed in '
          '%.2f s, none captured after, %d ragged launches in its warm-up, '
          '%d replays; memory %s [%s]'
          % (rid, row['pid'], row['params_step'], ladder['graphs'],
             row['warmup_s'], launches, sum(ladder['replays'].values()),
             row['device_memory'], gpu))
    return {'launches': launches, 'replays': sum(ladder['replays'].values())}


def elastic_wave(mesh, requests) -> tuple:
    """Submit every request at once: the time before the first submit,
    the futures, and each one's completion time (a done callback)."""
    done = []
    futures = []
    t0 = time.perf_counter()
    for lines in requests:
        future = mesh.submit(lines, tier='topk')
        future.add_done_callback(lambda f: done.append(time.perf_counter()))
        futures.append(future)
    return t0, futures, done


def elastic_answers(futures, expected, what: str) -> int:
    """Every admitted request answered bit for bit as ``predict``."""
    for future, want in zip(futures, expected):
        diff = result_diff(future.result(timeout=600), want, what)
        check(diff == 0, 'mesh elastic %s: max |diff| %.3g vs predict'
              % (what, diff))
    return len(futures)


def mesh_elastic_phase(model, gpu: str) -> dict:
    """The elastic fleet at java14m width (bf16, packed wire, the default
    ladder), in the shape of the reference's acceptance drill without
    placement: a socket mesh of 1 worker under the autoscaler; a backlog
    of 1024-line requests (one request a batch, so each is served as
    ``predict`` serves it) that ``tick()`` answers with a scale-up; the
    port's ``mesh_worker`` module started outside the mesh; r0 SIGKILLed
    mid-batch; the outside worker adopted, serving, then killed; a
    wrong-proto dial-in refused; a scale-down by drain once idle.
    Returns the workers' warm-up launches and their graph replays."""
    import copy
    import dataclasses
    import signal
    import socket
    import subprocess
    import torch
    from code2vec_tpu_torch.serving import transport as transport_lib
    started = time.perf_counter()
    rng = np.random.default_rng(41)
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    root = SMOKE_DIR / 'mesh_elastic'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    path = str(root / 'model')
    saved = copy.copy(model)
    saved.config = dataclasses.replace(model.config, MODEL_SAVE_PATH=path,
                                       **MESH_ELASTIC_KNOBS)
    saved.save(epoch=0, state=model.trainer.state_from_params())
    requests = [tile_lines(rng, 1024, sizes)
                for _ in range(MESH_ELASTIC_REQUESTS)]
    expected = [model.predict(lines, tier='topk') for lines in requests]
    rows_wave = sum(len(lines) for lines in requests)
    used0 = card_used_bytes()
    reserved0 = torch.cuda.memory_reserved()
    launches = replays = 0
    pids = []
    mesh = ext = None
    ext_log = open(root / 'ext-smoke.log', 'w')
    try:
        t0 = time.perf_counter()
        # unbounded: a wave outgrows one worker's auto bound (8 x 1024
        # rows), which is the backlog the autoscaler is to read
        mesh = saved.serving_mesh(replicas=1, mode='socket',
                                  max_delay_ms=2.0, queue_bound=-1)
        asc = mesh._autoscaler
        check(asc is not None, 'mesh elastic: no autoscaler')
        pids.append(mesh._replicas[0].transport.pid)
        used1 = card_used_bytes()
        print('mesh elastic: socket mesh of 1 worker ready in %.1f s, the '
              'card +%d bytes [%s]' % (time.perf_counter() - t0,
                                       used1 - used0, gpu))
        mesh_parity(mesh, model, rng, sizes, gpu, 'elastic, r0')
        got = elastic_worker(mesh, 'r0', gpu)
        launches += got['launches']

        # the scale-up: a backlog one stalled worker cannot drain, read
        # by the autoscaler itself
        t_wave, futures, done = elastic_wave(mesh, requests)
        drain_s, queued, rate = mesh._queue.drain_seconds()
        t0 = time.perf_counter()
        decision = asc.tick()
        scale_up_s = time.perf_counter() - t0
        check(decision == 'up' and asc.stats()['scale_up_total'] == 1,
              'mesh elastic: tick() %r at drain %.3f s, %r'
              % (decision, drain_s, asc.stats()))
        served = elastic_answers(futures, expected, 'wave 1')
        before = rows_wave / (max(done) - t_wave)
        pids.append(mesh._replicas[1].transport.pid)
        used2 = card_used_bytes()
        print('mesh elastic: scale-up: tick() read a drain of %.3f s (%d '
              'rows queued, fleet %.0f rows/s, threshold %.2f s) and '
              'returned %r after %.2f s with r1 warmed and seated; the '
              'card +%d bytes for r1; wave 1 (%d requests, %d rows, each '
              'batch stalled 250 ms) answered bit for bit at %.1f rows/s '
              '[%s]' % (drain_s, queued, rate,
                        MESH_ELASTIC_KNOBS['AUTOSCALE_UP_QUEUE_SECS'],
                        decision, scale_up_s, used2 - used1, served,
                        rows_wave, before, gpu))
        got = elastic_worker(mesh, 'r1', gpu)
        launches += got['launches']

        # the outside worker: the mesh's own overrides, cold-starting
        # while the load below runs
        config_path = root / 'ext-smoke.json'
        config_path.write_text(json.dumps(mesh._worker_overrides))
        host, port = mesh._listener.address
        ext = subprocess.Popen(
            [sys.executable, '-m', 'code2vec_tpu_torch.serving.mesh_worker',
             '--address', '%s:%d' % (host, port), '--rid', 'ext-smoke',
             '--config-json', str(config_path), '--device', DEVICE],
            cwd=str(ROOT), stdout=ext_log, stderr=subprocess.STDOUT)
        pids.append(ext.pid)
        t_ext = time.perf_counter()

        # after the scale-up: the same wave through 2 stalled workers
        t_wave, futures, done = elastic_wave(mesh, requests)
        elastic_answers(futures, expected, 'wave 2')
        after = rows_wave / (max(done) - t_wave)
        print('mesh elastic: wave 2 through r0 and r1 at %.1f rows/s, %.2fx '
              'of 1 worker (each batch stalled 250 ms) [%s]'
              % (after, after / before, gpu))

        # the kill: SIGKILL r0 while it holds a batch
        slot0 = mesh._replicas[0]
        replays += sum(slot0.transport.stats()['ladder']['replays'].values())
        t_wave, futures, done = elastic_wave(mesh, requests)
        wait_for(lambda: slot0.inflight >= 1, 60.0, 'r0 holding a batch')
        first_pid = slot0.transport.pid
        os.kill(first_pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        served = elastic_answers(futures, expected, 'kill drill')
        wait_for(lambda: mesh.stats()['restarts_total'] >= 1
                 and not slot0.dead, 300.0, 'r0 rejoining')
        rejoin_s = time.perf_counter() - t_kill
        stats = mesh.stats()
        check(stats['redispatched_total'] >= 1,
              'mesh elastic: no request redispatched after the kill')
        pids.append(slot0.transport.pid)
        print('mesh elastic: kill drill: r0 (pid %d) SIGKILLed holding a '
              'batch; %d requests answered bit for bit, none lost, %d '
              'redispatched; r0 rejoined as pid %d %.2f s after the kill '
              '[%s]' % (first_pid, served, stats['redispatched_total'],
                        slot0.transport.pid, rejoin_s, gpu))
        got = elastic_worker(mesh, 'r0', gpu)
        launches += got['launches']

        # the adoption: ext-smoke at the fleet's step, serving bit for bit
        wait_for(lambda: mesh.stats()['adopted_total'] >= 1
                 or ext.poll() is not None, 300.0, 'the adoption')
        t_seated = time.perf_counter()
        check(ext.poll() is None, 'mesh elastic: ext-smoke exited %s: %s'
              % (ext.poll(), (root / 'ext-smoke.log').read_text()[-2000:]))
        ext_slot = next(s for s in mesh._replicas if s.rid == 'ext-smoke')
        adopt_s = t_seated - ext_slot.transport.hello['t_hello']
        rows = {r['replica']: r for r in mesh.stats()['replicas']}
        check(rows['ext-smoke']['adopted'] and rows['ext-smoke']['pid']
              == ext.pid and rows['ext-smoke']['params_step']
              == mesh.stats()['params_step'],
              'mesh elastic: ext-smoke row %r' % rows['ext-smoke'])
        deadline = time.perf_counter() + 120.0
        rounds = 0
        while rounds == 0 or ext_slot.batches == 0:   # ext-smoke served
            check(time.perf_counter() < deadline,
                  'mesh elastic: ext-smoke never served')
            t_wave, futures, done = elastic_wave(mesh, requests[:3])
            elastic_answers(futures, expected[:3], 'adopted')
            rounds += 1
        print('mesh elastic: ext-smoke (pid %d) adopted at step %s %.2f s '
              'after its dial-in (its cold start included; %.2f s after its '
              'process started), devices %s; served bit for bit (%d '
              'rounds of 3 requests) [%s]'
              % (ext.pid, rows['ext-smoke']['params_step'], adopt_s,
                 t_seated - t_ext, rows['ext-smoke']['devices'], rounds,
                 gpu))
        got = elastic_worker(mesh, 'ext-smoke', gpu)
        launches += got['launches']
        replays += got['replays']

        # its death: retired, no restart charged here
        restarts = mesh.stats()['restarts_total']
        ext.kill()
        ext.wait(timeout=60)
        wait_for(lambda: ext_slot.retired, 60.0, 'ext-smoke retiring')
        time.sleep(1.0)   # a wrong supervised restart would act by now
        stats = mesh.stats()
        check(ext_slot.retired_reason == 'adopted_worker_exit'
              and stats['restarts_total'] == restarts,
              'mesh elastic: ext-smoke retired %r, restarts %d -> %d'
              % (ext_slot.retired_reason, restarts,
                 stats['restarts_total']))

        # a dial-in speaking another wire protocol: refused typed
        conn = socket.create_connection((host, port), timeout=30.0)
        wrong = transport_lib.SocketTransport(conn)
        wrong.send(('hello', 'ext-wrong', transport_lib.WIRE_PROTO + 1,
                    os.getpid()))
        kind, why = wrong.recv()[:2]
        wrong.close()
        wait_for(lambda: mesh.stats()['proto_rejected_total'] >= 1, 10.0,
                 'the proto refusal')
        check(kind == 'adopt_rejected' and 'proto' in why,
              'mesh elastic: wrong proto answered %r' % ((kind, why),))
        print('mesh elastic: ext-smoke killed: retired as %r, restarts_total '
              'still %d; a wire-proto %d dial-in refused typed (%r) [%s]'
              % (ext_slot.retired_reason, restarts,
                 transport_lib.WIRE_PROTO + 1, why, gpu))

        # the scale-down: once idle, tick() drains r1 out
        wait_for(lambda: all(r['inflight'] == 0
                             for r in mesh.stats()['replicas']), 60.0,
                 'the fleet idle')
        got = elastic_worker(mesh, 'r1', gpu)
        replays += got['replays']
        first = asc.tick()
        time.sleep(MESH_ELASTIC_IDLE + 0.05)
        t0 = time.perf_counter()
        decision = asc.tick()
        drain_down_s = time.perf_counter() - t0
        stats = mesh.stats()
        rows = {r['replica']: r for r in stats['replicas']}
        check(first == 'hold' and decision == 'down'
              and rows['r1']['retired_reason'] == 'autoscale'
              and stats['replicas_live'] == 1,
              'mesh elastic: scale-down ticks %r, %r; r1 %r'
              % (first, decision, rows['r1']))
        t_wave, futures, done = elastic_wave(mesh, requests[:2])
        elastic_answers(futures, expected[:2], 'after the scale-down')
        mesh_parity(mesh, model, rng, sizes, gpu, 'elastic, after the '
                    'scale-down')
        got = elastic_worker(mesh, 'r0', gpu)
        replays += got['replays']
        print('mesh elastic: scale-down: idle for %.1f s, tick() drained r1 '
              'out in %.2f s (retired %r); the fleet of r0 serves bit for '
              'bit; autoscaler %s [%s]'
              % (MESH_ELASTIC_IDLE, drain_down_s,
                 rows['r1']['retired_reason'], stats['autoscaler'], gpu))
        print('mesh elastic: scale-up %.2f s; adoption %.2f s; scale-down '
              'drain %.2f s; kill to rejoin %.2f s; rows/s %.1f before and '
              '%.1f after the scale-up; +%d bytes of the card a worker [%s]'
              % (scale_up_s, adopt_s, drain_down_s, rejoin_s, before, after,
                 used2 - used1, gpu))
    finally:
        if ext is not None and ext.poll() is None:
            ext.kill()
            ext.wait(timeout=60)
        ext_log.close()
        if mesh is not None:
            mesh.close()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    alive = [pid for pid in pids if pid_alive(pid)]
    t0 = time.perf_counter()
    while True:
        used_end = card_used_bytes()
        reserved_end = torch.cuda.memory_reserved()
        left = (used_end - used0) - (reserved_end - reserved0)
        if left <= MESH_MEMORY_SLACK or time.perf_counter() - t0 > 20.0:
            break
        time.sleep(0.5)
    check(not alive and left <= MESH_MEMORY_SLACK,
          'mesh elastic after close(): pids alive %s, the card %+d bytes '
          'from before, %+d of them this process\'s'
          % (alive, used_end - used0, reserved_end - reserved0))
    print('mesh elastic closed: %d worker pids, none alive; the workers left '
          '%+d bytes on the card (slack %d) [%s]'
          % (len(pids), left, MESH_MEMORY_SLACK, gpu))
    print('mesh elastic phase: %.1f s' % (time.perf_counter() - started))
    return {'launches': launches, 'replays': replays}


MESH_BACKHAUL_SECONDS = 1.5     # each load run of the backhaul's cost
MESH_BACKHAUL_BEAT = 0.5        # the phase's MESH_HEARTBEAT_SECS
MESH_BACKHAUL_BACKOFF = 1.0     # the kill drill's restart backoff
MESH_BACKHAUL_MEMORY = 0.10     # a worker's ledger against its reserved bytes
#: the series of its engine and ledger each backhauled worker must have in
#: the fleet's Prometheus export, labeled with its replica
MESH_BACKHAUL_SERIES = ('serving/batches_total', 'serving/batch_fill_rate',
                        'serving/dispatch_ms', 'serving/latency_ms',
                        'jit/compiles_total', 'mem/attributed_bytes')


def topk_rows_per_s(mesh, pool_lines, seconds: float) -> dict:
    """LOAD_THREADS caller threads of topk requests of 1-64 lines through
    ``mesh.submit`` for ``seconds``: rows/s and the client p99 (host
    clock). Every request must return its rows."""
    import threading
    done, errors = [], []
    lock = threading.Lock()

    def caller(seed):
        r = np.random.default_rng(seed)
        end = time.perf_counter() + seconds
        mine = []
        try:
            while time.perf_counter() < end:
                n = int(r.integers(1, 65))
                start = int(r.integers(0, len(pool_lines) - n))
                t0 = time.perf_counter()
                results = mesh.submit(pool_lines[start:start + n],
                                      tier='topk').result(timeout=300)
                mine.append((n, time.perf_counter() - t0))
                check(len(results) == n, 'wrong result count under load')
        except BaseException as exc:
            errors.append(exc)
        with lock:
            done.extend(mine)

    threads = [threading.Thread(target=caller, args=(500 + i,))
               for i in range(LOAD_THREADS)]
    t0 = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    wall = time.perf_counter() - t0
    check(not errors and done, 'mesh backhaul load: %r' % errors[:3])
    lat = sorted(d[1] for d in done)
    return {'requests': len(done),
            'rows_per_s': sum(d[0] for d in done) / wall,
            'p99_ms': 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]}


def backhaul_wire(mesh, pool_lines, seconds: float) -> dict:
    """Topk load through ``mesh`` for ``seconds`` with its receivers
    watched: the bytes of each heartbeat frame and of each dispatch
    result frame's span bundles (re-pickled as a frame's payload is),
    how many beats carried a rider, the members a result frame answers,
    and the parent's host seconds in the fleet merge of a beat, the
    stitching of a result frame and of a beat, and the tracer's end of a
    trace (the retention decision and the span log's write). The watch
    is taken off after."""
    from code2vec_tpu_torch.serving import transport as transport_lib
    got = {'beat_bytes': [], 'riders': 0, 'bundle_bytes': [],
           'members': [], 'merge_s': [], 'stitch_result_s': [],
           'stitch_beat_s': [], 'finish_trace_s': [], 'beat': None}

    def timed(fn, into):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                into.append(time.perf_counter() - t0)
        return call

    def watch(real):
        def recv():
            msg = real()
            if msg[0] == 'heartbeat':
                beat = msg[2]
                got['beat_bytes'].append(
                    len(transport_lib.encode_frame(msg)))
                got['riders'] += bool(beat.spans or beat.telemetry
                                      or beat.ledger)
                got['beat'] = msg
            elif msg[0] == 'result' and len(msg) > 3:
                got['bundle_bytes'].append(len(pickle.dumps(msg[3])))
                got['members'].append(len(msg[2]))
            return msg
        return recv

    watched = []
    for slot in mesh._replicas:
        transport = slot.transport
        merge = transport._on_telemetry
        transport._channel.recv = watch(transport._channel.recv)
        transport._adopt_member_bundles = timed(
            transport._adopt_member_bundles, got['stitch_result_s'])
        transport._adopt_pending_bundles = timed(
            transport._adopt_pending_bundles, got['stitch_beat_s'])
        transport._on_telemetry = timed(merge, got['merge_s'])
        watched.append((transport, merge))
    tracer = mesh._tracer
    tracer._finish_trace = timed(tracer._finish_trace, got['finish_trace_s'])
    try:
        got['load'] = topk_rows_per_s(mesh, pool_lines, seconds)
        time.sleep(2 * MESH_BACKHAUL_BEAT)   # the beats after the load
    finally:
        del tracer._finish_trace
        for transport, merge in watched:
            del transport._channel.recv
            del transport._adopt_member_bundles
            del transport._adopt_pending_bundles
            transport._on_telemetry = merge
    got['unpickle_beat_s'] = 0.0
    if got['beat'] is not None:
        payload = pickle.dumps(got['beat'])
        t0 = time.perf_counter()
        for _ in range(100):
            pickle.loads(payload)
        got['unpickle_beat_s'] = (time.perf_counter() - t0) / 100
    return got


def delivered_traces(path: Path) -> dict:
    """The mesh requests delivered ok in a span log: {trace id: its
    records}."""
    traces = {}
    for line in open(path):
        record = json.loads(line)
        traces.setdefault(record['trace'], []).append(record)
    out = {}
    for tid, records in traces.items():
        root = next((r for r in records if r['parent'] is None), None)
        if root is not None and root['name'] == 'serving.request' and \
                root.get('status') == 'ok' and \
                (root.get('attrs') or {}).get('mesh'):
            out[tid] = records
    return out


def remote_subtrees(records) -> list:
    """Each ``serving.remote`` envelope of one trace with the span ids
    under it: ``[(envelope record, {ids})]``."""
    children = {}
    for r in records:
        children.setdefault(r['parent'], []).append(r['span'])
    out = []
    for r in records:
        if r['name'] != 'serving.remote':
            continue
        ids, todo = set(), [r['span']]
        while todo:
            span = todo.pop()
            ids.add(span)
            todo.extend(children.get(span, ()))
        out.append((r, ids))
    return out


def mesh_backhaul_phase(model, gpu: str) -> dict:
    """Fleet observability for worker replicas at java14m width (bf16,
    packed wire, the default ladder), telemetry on with a telemetry
    directory, tracing at rate 1.0: a socket mesh with the backhaul at
    AUTO (on: resolved at each spawn) beside a socket mesh with it forced
    to 0, 2 workers each. The first mesh's r0 is armed with
    ``kill_worker_after_execute`` on its second dispatch and restarts
    after a short backoff while r1 joins unarmed (``add_replica``). The
    drill's requests and the parity cases bit for bit ``predict``;
    every delivered traced request of the first mesh stitched (an
    envelope with the device work under it), the killed one showing both
    incarnations in order; the fleet's Prometheus export with each
    worker's series labeled and no family split, no capture after
    warm-up, clock offsets set; ``worker_memory`` against each worker's
    reserved bytes; the second mesh's beats with no riders and its traces
    with no envelope; the backhaul's cost, topk rows/s on against off, A
    B B A at the default sample rate and at 1.0; the bytes and host
    seconds of a beat and of a result frame's bundles; every worker gone
    after ``close()``. Returns the workers' warm-up launches and their
    graph replays."""
    import copy
    import dataclasses
    import subprocess
    import threading
    import torch
    from code2vec_tpu_torch.telemetry import catalog, core, exporters
    started = time.perf_counter()
    rng = np.random.default_rng(51)
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    pool_lines = make_lines(rng, 4096, sizes, model.config.MAX_CONTEXTS)
    root = SMOKE_DIR / 'mesh_backhaul'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    knobs = dict(MODEL_SAVE_PATH=str(root / 'model'),
                 TRACING_SAMPLE_RATE=1.0,
                 MESH_HEARTBEAT_SECS=MESH_BACKHAUL_BEAT,
                 MESH_HEARTBEAT_MISSES=8,
                 MESH_RESTART_BACKOFF_SECS=MESH_BACKHAUL_BACKOFF)
    tele_on, tele_off = root / 'telemetry_on', root / 'telemetry_off'
    on = copy.copy(model)
    on.config = dataclasses.replace(
        model.config, TELEMETRY_DIR=str(tele_on),
        # counted from 0: the worker's second dispatch
        FAULT_INJECT='kill_worker_after_execute@dispatch=1', **knobs)
    off = copy.copy(model)
    off.config = dataclasses.replace(
        model.config, TELEMETRY_DIR=str(tele_off),
        MESH_TELEMETRY_BACKHAUL=0, **knobs)
    on.save(epoch=0, state=model.trainer.state_from_params())
    drill = [tile_lines(rng, 64, sizes) for _ in range(2)]
    expected = [model.predict(lines, tier='topk') for lines in drill]
    default_rate = model.config.tracing_sample_rate
    used0 = card_used_bytes()
    reserved0 = torch.cuda.memory_reserved()
    launches = replays = 0
    pids = []
    mesh_on = mesh_off = None
    core.reset()
    core.enable()
    try:
        built = build_meshes({
            'on': lambda: on.serving_mesh(replicas=1, mode='socket',
                                          max_delay_ms=2.0),
            'off': lambda: off.serving_mesh(replicas=2, mode='socket',
                                            max_delay_ms=2.0)})
        mesh_on, mesh_off = built['on'][0], built['off'][0]
        pids += [s.transport.pid for m in (mesh_on, mesh_off)
                 for s in m._replicas]
        print('mesh backhaul: a socket mesh of 1 worker, backhaul AUTO '
              '(telemetry on: 1), ready in %.1f s; one of 2 workers, '
              'backhaul 0, ready in %.1f s; the card +%d bytes [%s]'
              % (built['on'][1], built['off'][1],
                 card_used_bytes() - used0, gpu))

        # r1 and every restart come up unarmed; r1 cold-starts while r0
        # runs the drill
        mesh_on._worker_overrides['FAULT_INJECT'] = ''
        added = {}

        def add():
            try:
                added['rid'] = mesh_on.add_replica()
            except BaseException as exc:
                added['error'] = exc

        adder = threading.Thread(target=add)
        adder.start()
        slot0 = mesh_on._replicas[0]
        first_pid = slot0.transport.pid
        seen = {}

        def watch_r0():
            # the death verdict and the rejoin, off the drill's thread
            while not mesh_on._closed and 'rejoin' not in seen:
                if slot0.dead and 'dead' not in seen:
                    seen['dead'] = time.perf_counter()
                if 'dead' in seen and not slot0.dead and \
                        slot0.transport.pid != first_pid:
                    seen['rejoin'] = time.perf_counter()
                time.sleep(0.002)

        watcher = threading.Thread(target=watch_r0, daemon=True)
        watcher.start()
        # r0's first dispatch: a clean round trip
        diff = result_diff(mesh_on.predict(drill[0], tier='topk',
                                           timeout=300),
                           expected[0], 'backhaul drill, clean')
        check(diff == 0, 'mesh backhaul: the clean request differs from '
              'predict by %.3g' % diff)
        row = slot0.transport.stats()
        check(row['graph_captures_after_warmup'] == 0,
              'mesh backhaul: r0 captured after warm-up')
        launches += row['kernel_launches']['ragged_fwd']
        replays += sum(row['ladder']['replays'].values())
        # its second: executed, its spans home on a beat, SIGKILLed before
        # the result frame, redispatched, served by r1 or r0's restart
        t0 = time.perf_counter()
        diff = result_diff(mesh_on.predict(drill[1], tier='topk',
                                           timeout=600),
                           expected[1], 'backhaul drill, killed')
        answered_s = time.perf_counter() - t0
        check(diff == 0, 'mesh backhaul: the killed request differs from '
              'predict by %.3g' % diff)
        adder.join(timeout=600)
        check('rid' in added, 'mesh backhaul: add_replica failed: %r'
              % (added.get('error'),))
        wait_for(lambda: 'rejoin' in seen, 300.0, 'r0 rejoining',
                 'mesh backhaul')
        stats = mesh_on.stats()
        check(stats['redispatched_total'] >= 1
              and stats['adopted_spans_total'] > 0,
              'mesh backhaul: redispatched %d, adopted spans %d'
              % (stats['redispatched_total'], stats['adopted_spans_total']))
        pids += [s.transport.pid for s in mesh_on._replicas]
        served_by = {s.rid: s.batches for s in mesh_on._replicas}
        rejoin_s = seen['rejoin'] - seen['dead']
        print('mesh backhaul kill drill: r0 (pid %d) SIGKILLed after the '
              'device work of its second dispatch; the request answered '
              'bit for bit %.2f s after its submit, %d redispatched; r0 '
              'declared dead, then rejoined as pid %d %.2f s later (%.1f s '
              'backoff); r1 joined meanwhile; batches %s [%s]'
              % (first_pid, answered_s, stats['redispatched_total'],
                 slot0.transport.pid, rejoin_s, MESH_BACKHAUL_BACKOFF,
                 served_by, gpu))

        # every live worker: its own ladder, captured at warm-up and never
        # after; requests alone bit for bit predict
        for mesh, tag in ((mesh_on, 'backhaul on'),
                          (mesh_off, 'backhaul off')):
            rows = worker_rows(mesh, 'ragged_fwd', gpu, tag)
            launches += sum(r['kernel_launches']['ragged_fwd']
                            for r in rows)
            mesh_parity(mesh, model, rng, sizes, gpu, tag)

        # the fleet's capture count after warm-up: every worker's first
        # snapshot in (a beat comes only after the ready frame)
        reg = core.registry()
        compiles = {s.rid: catalog.labeled('jit/compiles_total', 'replica',
                                           s.rid)
                    for s in mesh_on._replicas}
        wait_for(lambda: all(s.transport._merge_last
                             for s in mesh_on._replicas), 30.0,
                 'every backhauled worker\'s first snapshot', 'mesh backhaul')
        warm_compiles = {rid: getattr(reg.get(name), 'value', None)
                         for rid, name in compiles.items()}

        # the cost of the layer: A (backhaul on) B (off) B A at the
        # default sample rate, then at 1.0, after a second of traffic each
        for mesh in (mesh_on, mesh_off):
            topk_rows_per_s(mesh, pool_lines, 1.0)
        cost = {}
        for rate in (default_rate, 1.0):
            for mesh in (mesh_on, mesh_off):
                mesh._tracer.sample_rate = rate
            runs = {'A': [], 'B': []}
            for tag in 'ABBA':
                runs[tag].append(topk_rows_per_s(
                    mesh_on if tag == 'A' else mesh_off, pool_lines,
                    MESH_BACKHAUL_SECONDS))
            rates = {tag: sum(r['rows_per_s'] for r in reports)
                     for tag, reports in runs.items()}
            cost[rate] = rates['A'] / rates['B']
            print('mesh backhaul cost at sample rate %g (topk, %d threads x '
                  '%.0f s, 2 workers each): A = backhaul on, rows/s %s, p99 '
                  'ms %s; B = backhaul off, rows/s %s, p99 ms %s; A/B %.4f '
                  '[%s]' % (rate, LOAD_THREADS, MESH_BACKHAUL_SECONDS,
                            ['%.1f' % r['rows_per_s'] for r in runs['A']],
                            ['%.2f' % r['p99_ms'] for r in runs['A']],
                            ['%.1f' % r['rows_per_s'] for r in runs['B']],
                            ['%.2f' % r['p99_ms'] for r in runs['B']],
                            cost[rate], gpu))

        # the wire and the parent's host cost, at rate 1.0
        wire = {name: backhaul_wire(mesh, pool_lines, MESH_BACKHAUL_SECONDS)
                for name, mesh in (('on', mesh_on), ('off', mesh_off))}
        for name, got in wire.items():
            n_beats = max(len(got['beat_bytes']), 1)
            n_frames = max(len(got['bundle_bytes']), 1)
            print('mesh backhaul wire (%s, rate 1.0, %.0f rows/s): %d beats '
                  'of mean %.0f bytes, %d with a rider; %d result frames, '
                  '%.2f members each, bundles of mean %.0f bytes; parent '
                  'host per beat: unpickle %.1f us, merge %.1f us, '
                  'stitch %.1f us; per result frame: stitch %.1f us; per '
                  'trace the tracer\'s end (the span log\'s write) %.1f us '
                  'over %d traces [%s]'
                  % (name, got['load']['rows_per_s'], len(got['beat_bytes']),
                     sum(got['beat_bytes']) / n_beats, got['riders'],
                     len(got['bundle_bytes']),
                     sum(got['members']) / n_frames,
                     sum(got['bundle_bytes']) / n_frames,
                     1e6 * got['unpickle_beat_s'],
                     1e6 * sum(got['merge_s']) / n_beats,
                     1e6 * sum(got['stitch_beat_s']) / n_beats,
                     1e6 * sum(got['stitch_result_s']) / n_frames,
                     1e6 * sum(got['finish_trace_s'])
                     / max(len(got['finish_trace_s']), 1),
                     len(got['finish_trace_s']), gpu))
        check(wire['on']['riders'] > 0 and wire['off']['riders'] == 0
              and wire['off']['beat_bytes'],
              'mesh backhaul: beats with riders: on %d, off %d of %d'
              % (wire['on']['riders'], wire['off']['riders'],
                 len(wire['off']['beat_bytes'])))

        # the fleet export: each worker's series labeled, no family split,
        # no capture after warm-up, the clock offsets set
        exporter = exporters.PrometheusExporter(str(root / 'prom'))
        exporter.flush(reg, step=0)
        text = open(exporter.path).read().splitlines()
        seen_families, last = set(), None
        for line in text:
            if line.startswith('#'):
                continue
            family = line.split('{')[0].split(' ')[0]
            check(family == last or family not in seen_families,
                  'mesh backhaul: family %s split in the fleet export'
                  % family)
            seen_families.add(family)
            last = family
        missing = [(s.rid, name) for s in mesh_on._replicas
                   for name in MESH_BACKHAUL_SERIES
                   if not any(line.startswith(catalog.prometheus_name(name))
                              and 'replica="%s"' % s.rid in line
                              for line in text)]
        check(not missing, 'mesh backhaul: series missing from the fleet '
              'export: %s' % missing)
        after_compiles = {rid: getattr(reg.get(name), 'value', None)
                          for rid, name in compiles.items()}
        check(after_compiles == warm_compiles
              and all(n for n in warm_compiles.values()),
              'mesh backhaul: jit/compiles_total per replica %s after '
              'warm-up, %s after the load' % (warm_compiles, after_compiles))
        offsets = {s.rid: reg.get(catalog.labeled(
            'mesh/clock_offset_ms', 'replica', s.rid))
            for s in mesh_on._replicas}
        check(all(g is not None for g in offsets.values()),
              'mesh backhaul: mesh/clock_offset_ms unset: %s' % offsets)
        print('mesh backhaul fleet export: %d lines, %d families, none '
              'split; each worker\'s %s labeled; jit/compiles_total per '
              'replica %s, unchanged since warm-up (r0 counts both '
              'incarnations\' warm-ups); mesh/clock_offset_ms %s [%s]'
              % (len(text), len(seen_families), list(MESH_BACKHAUL_SERIES),
                 warm_compiles, {rid: round(g.value, 4)
                                 for rid, g in offsets.items()}, gpu))

        # each worker's memory as its beats report it, against what its
        # caching allocator reserves (the graph pool is the executables
        # bucket, outside attributed_bytes)
        reserved = {r['replica']: (r['device_memory'] or {}).get(
            'reserved', 0) for r in mesh_on.replica_stats()}
        stats = mesh_on.stats()
        memory = {}
        for row in stats['replicas']:
            ledger = row['worker_memory']
            check(ledger is not None, 'mesh backhaul: no worker_memory for '
                  '%s' % row['replica'])
            held = ledger['attributed_bytes'] + \
                ledger['buckets']['executables']
            memory[row['replica']] = (ledger['attributed_bytes'],
                                      ledger['buckets']['executables'],
                                      reserved[row['replica']])
            check(abs(held - reserved[row['replica']])
                  <= MESH_BACKHAUL_MEMORY * reserved[row['replica']],
                  'mesh backhaul: %s ledger %d (attributed %d + '
                  'executables %d) against %d reserved'
                  % (row['replica'], held, ledger['attributed_bytes'],
                     ledger['buckets']['executables'],
                     reserved[row['replica']]))
        off_stats = mesh_off.stats()
        check(all(r['worker_memory'] is None for r in off_stats['replicas'])
              and off_stats['worker_snapshots_total'] == 0
              and off_stats['adopted_spans_total'] == 0
              and off_stats['remote_spans_dropped_total'] == 0,
              'mesh backhaul: the mesh with the backhaul off merged %d '
              'snapshots, %d spans' % (off_stats['worker_snapshots_total'],
                                       off_stats['adopted_spans_total']))
        print('mesh backhaul memory: per worker (attributed, executables, '
              'reserved) bytes %s, within %.0f%%; clock offsets ms %s; '
              'spans adopted %d, dropped %d, worker snapshots %d; the mesh '
              'with the backhaul off: no worker_memory, 0 snapshots, 0 '
              'spans [%s]'
              % (memory, 100 * MESH_BACKHAUL_MEMORY,
                 {r['replica']: r['clock_offset_ms']
                  for r in stats['replicas']},
                 stats['adopted_spans_total'],
                 stats['remote_spans_dropped_total'],
                 stats['worker_snapshots_total'], gpu))
        replays += total_replays(mesh_on) + total_replays(mesh_off)
    finally:
        for mesh in (mesh_on, mesh_off):
            if mesh is not None:
                mesh.close()
        core.disable()
        core.reset()
    torch.cuda.empty_cache()

    # the span logs: every delivered traced request of the backhauled
    # mesh stitched, the killed one with both incarnations in order; none
    # of the other mesh's with an envelope
    delivered = delivered_traces(tele_on / 'spans.jsonl')
    unstitched, adopted, both = [], [], []
    for tid, records in delivered.items():
        envelopes = remote_subtrees(records)
        under = {r['parent'] for r in records
                 if r['name'] == 'serving.device_execute'}
        if not envelopes or any(env['span'] not in under
                                for env, _ids in envelopes):
            unstitched.append(tid)
        adopted.append(sum(len(ids) for _env, ids in envelopes))
        if len(envelopes) == 2:
            both.append(sorted((env for env, _ids in envelopes),
                               key=lambda r: r['t0']))
    check(delivered and not unstitched, 'mesh backhaul: %d of %d delivered '
          'traces unstitched' % (len(unstitched), len(delivered)))
    check(len(both) == 1 and both[0][0]['attrs']['pid'] == first_pid
          and both[0][1]['attrs']['pid'] != first_pid
          and both[0][0]['t1'] <= both[0][1]['t0'],
          'mesh backhaul: the killed request\'s envelopes %s' % both)
    report = subprocess.run(
        [sys.executable, str(ROOT / 'scripts' / 'latency_report.py'),
         '--spans', str(tele_on / 'spans.jsonl'), '--fleet', '--json',
         '--top', '0'], capture_output=True, text=True, timeout=300)
    rows = [json.loads(line) for line in report.stdout.splitlines()
            if line.startswith('{')]
    fleet_unstitched = [r['value'] for r in rows
                        if r.get('measure') == 'unstitched_traces']
    check(report.returncode == 0 and fleet_unstitched == [0],
          'mesh backhaul: latency_report.py --fleet exit %d, unstitched %s: '
          '%s' % (report.returncode, fleet_unstitched, report.stderr[-2000:]))
    off_traces = delivered_traces(tele_off / 'spans.jsonl')
    check(off_traces and not any(r['name'] == 'serving.remote'
                                 for records in off_traces.values()
                                 for r in records),
          'mesh backhaul: the mesh with the backhaul off stitched spans')
    print('mesh backhaul traces: %d delivered traced requests, 0 unstitched '
          '(latency_report.py --fleet agrees), %.2f stitched spans a '
          'request; the killed request holds both incarnations\' envelopes '
          '(pids %d, %d), the first ending %.3f ms before the second began '
          '(clock offsets applied); the mesh with the backhaul off: %d '
          'traces, no envelope [%s]'
          % (len(delivered), sum(adopted) / len(adopted),
             both[0][0]['attrs']['pid'], both[0][1]['attrs']['pid'],
             1e3 * (both[0][1]['t0'] - both[0][0]['t1']), len(off_traces),
             gpu))
    shutil.rmtree(root, ignore_errors=True)
    alive = [pid for pid in pids if pid_alive(pid)]
    t0 = time.perf_counter()
    while True:
        used_end = card_used_bytes()
        reserved_end = torch.cuda.memory_reserved()
        left = (used_end - used0) - (reserved_end - reserved0)
        if left <= MESH_MEMORY_SLACK or time.perf_counter() - t0 > 20.0:
            break
        time.sleep(0.5)
    check(not alive and left <= MESH_MEMORY_SLACK,
          'mesh backhaul after close(): pids alive %s, the card %+d bytes '
          'from before, %+d of them this process\'s'
          % (alive, used_end - used0, reserved_end - reserved0))
    print('mesh backhaul closed: %d worker pids, none alive; the workers '
          'left %+d bytes on the card (slack %d); backhaul cost A/B %s [%s]'
          % (len(pids), left, MESH_MEMORY_SLACK,
             {rate: round(ratio, 4) for rate, ratio in cost.items()}, gpu))
    print('mesh backhaul phase: %.1f s' % (time.perf_counter() - started))
    return {'launches': launches, 'replays': replays}


# ------------------------------------------------ the scenario traffic plane
MESH_SERVE_WORKER_GB = 9.43     # ROADMAP C9: a worker's card bytes, java14m
MESH_SERVE_REQUESTS = (5, 50, 5, 50)   # lines a request, buckets 8 and 64


def nvidia_smi_cards() -> list:
    """Each card's (index, UUID, MiB used) as ``nvidia-smi`` reads them
    (its own numbering, which may differ from CUDA's)."""
    import subprocess
    out = subprocess.run(
        [shutil.which('nvidia-smi') or 'nvidia-smi',
         '--query-gpu=index,uuid,memory.used', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [tuple(part.strip() for part in line.split(','))
            for line in out.strip().splitlines()]


def mesh_serve_phase(model, gpu: str) -> dict:
    """Placement: socket workers each pinned to a card of its own
    (MESH_DEVICES_PER_REPLICA=1), one on a one-card host and two where the
    host has two or more, started together with an unplaced socket worker
    (topk tier, the model saved once): every placed worker reports the
    card of its slice with the UUID this process sees there (the mesh
    checks both at its cold start), each card's reserved bytes beside the
    prediction (ROADMAP C9), the placed answers bit for bit the unplaced
    worker's on the same requests; one slice more than the cards is the
    typed refusal at build. Returns the placed workers' launches."""
    import copy
    import dataclasses
    import torch
    from code2vec_tpu_torch.parallel import mesh as parallel_mesh
    started = time.perf_counter()
    rng = np.random.default_rng(43)
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    root = SMOKE_DIR / 'mesh_serve'
    shutil.rmtree(root, ignore_errors=True)
    path = str(root / 'model')
    saved = copy.copy(model)
    saved.config = dataclasses.replace(model.config, MODEL_SAVE_PATH=path)
    placed_model = copy.copy(model)
    placed_model.config = dataclasses.replace(
        model.config, MODEL_SAVE_PATH=path, MESH_DEVICES_PER_REPLICA=1)
    state = model.trainer.state_from_params()
    saved.save(epoch=0, state=state)
    del state
    cards = torch.cuda.device_count()
    n_placed = 2 if cards >= 2 else 1
    # one slice more than the host's cards: refused typed at build, before
    # any worker starts
    refusal = None
    try:
        placed_model.serving_mesh(replicas=cards + 1, mode='socket',
                                  tiers=('topk',))
    except ValueError as exc:
        refusal = str(exc)
    check(refusal is not None and 'Placement wants %d slices x 1 devices '
          'but only %d are visible' % (cards + 1, cards) in refusal,
          'placement on %d card(s) did not refuse %d slices: %r'
          % (cards, cards + 1, refusal))
    print('mesh placement: %d slice(s) on %d card(s) refused at build: %s '
          '[%s]' % (cards + 1, cards, refusal, gpu))
    smi_before = nvidia_smi_cards()
    built = build_meshes({
        'unplaced': lambda: saved.serving_mesh(
            replicas=1, mode='socket', tiers=('topk',), max_delay_ms=2.0),
        'placed': lambda: placed_model.serving_mesh(
            replicas=n_placed, mode='socket', tiers=('topk',),
            max_delay_ms=2.0)})
    unplaced, placed = built['unplaced'][0], built['placed'][0]
    try:
        smi_after = nvidia_smi_cards()
        stats = placed.stats()
        check(stats['placement'] == {'devices_per_replica': 1,
                                     'slices': n_placed, 'data_axis': 1},
              'placement stats %r' % (stats['placement'],))
        rows = worker_rows(placed, 'ragged_fwd', gpu, 'placed')
        for i, (row, slot) in enumerate(zip(stats['replicas'],
                                            placed._replicas)):
            caps = slot.transport.ready_info['capabilities']
            uuid = parallel_mesh.card_uuid(i)
            check(row['devices'] == [i] and row['device_indices'] == [i]
                  and caps['device_uuids'] == [uuid],
                  'placed worker %s: devices %s, slice %s, UUIDs %s against '
                  '%s' % (row['replica'], row['devices'],
                          row['device_indices'], caps['device_uuids'],
                          uuid))
            reserved = rows[i]['device_memory']['reserved']
            print('mesh placement: worker %s (pid %d) on card %d (%s), its '
                  'UUID %s the one this process sees at index %d; it '
                  'reserves %.2f GB on its card (predicted +%.2f GB, ROADMAP '
                  'C9) [%s]' % (row['replica'], row['pid'], i,
                                caps['device'], caps['device_uuids'][0], i,
                                reserved / 1e9, MESH_SERVE_WORKER_GB, gpu))
        unplaced_row = unplaced.stats()['replicas'][0]
        print('mesh placement: the unplaced worker reports cards %s; '
              'nvidia-smi (index, uuid, used) before %s, after %s; ready in '
              '%.1f s (placed) and %.1f s (unplaced) [%s]'
              % (unplaced_row['devices'], smi_before, smi_after,
                 built['placed'][1], built['unplaced'][1], gpu))
        diffs = []
        for n in MESH_SERVE_REQUESTS:
            lines = make_lines(rng, n, sizes, model.config.MAX_CONTEXTS)
            diffs.append(result_diff(
                placed.predict(lines, tier='topk', timeout=300),
                unplaced.predict(lines, tier='topk', timeout=300),
                'placed vs unplaced'))
        check(max(diffs) == 0, 'placed workers against the unplaced one: '
              'max |diff| %s' % diffs)
        batches = [r['batches'] for r in placed.stats()['replicas']]
        print('mesh placement: %d requests (%s lines) through %d placed '
              'worker(s) bit for bit the unplaced worker\'s answers; batches '
              'a placed worker %s [%s]' % (len(MESH_SERVE_REQUESTS),
                                           MESH_SERVE_REQUESTS, n_placed,
                                           batches, gpu))
        launches = sum(r['kernel_launches']['ragged_fwd'] for r in rows)
        replays = total_replays(placed)
    finally:
        placed.close()
        unplaced.close()
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print('mesh placement phase: %.1f s' % (time.perf_counter() - started))
    return {'launches': launches, 'replays': replays}


WORKLOADS_CLASSES = 40          # synthetic classes per language
WORKLOADS_RATE_RPS = 200.0      # the synthetic profile's arrival rate
# the paced replays' speed-ups: one the fleet keeps up with, one above it
WORKLOADS_RATE_SCALES = (1.0, 3.0)
WORKLOADS_PACED_SECONDS = 4.0   # each paced replay's planned window
WORKLOADS_SHADOW = 16           # the index rollovers' shadow queries
WORKLOADS_LATENCY_LINES = 64    # single-line requests per latency sample
WORKLOADS_ALLOCATED_SLACK = 64 << 20   # this process's bytes after close()
# the fields of a replay's cell that do not depend on timing or the memo
WORKLOADS_CELL_FIELDS = ('requests', 'delivered', 'shed', 'errors', 'scored',
                         'exact_match', 'f1', 'precision', 'recall')


class BoomIndex:
    """A rollover candidate that cannot answer."""

    def search(self, vectors, k):
        raise RuntimeError('candidate index cannot answer')


class TimedIndex:
    """An attached index that times each search and notes the thread
    that ran it (a replica's completion threads ``serving-decode-rN_i``,
    the mesh's ``mesh-aux_i``); every other attribute is the index's
    own."""

    def __init__(self, index):
        import collections
        import threading
        self._inner = index
        self._lock = threading.Lock()
        self.seconds = collections.defaultdict(list)   # thread -> [s]

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def search(self, vectors, k):
        import threading
        t0 = time.perf_counter()
        try:
            return self._inner.search(vectors, k)
        finally:
            took = time.perf_counter() - t0
            with self._lock:
                self.seconds[threading.current_thread().name].append(took)

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()


class InstantIndex:
    """A control index: every query gets the top-k of one search made at
    construction, with no work of its own, so a replay against it shows
    the fleet without the searches on its completion path."""

    def __init__(self, index, vector, k: int):
        self.labels = index.labels
        self.dim = index.dim
        self._values, self._indices = index.search(vector[None], k)

    def search(self, vectors, k):
        n = np.atleast_2d(vectors).shape[0]
        return (np.repeat(self._values[:, :k], n, axis=0),
                np.repeat(self._indices[:, :k], n, axis=0))


def respell(line: str, sizes, salt: int = 0) -> str:
    """An extracted context line with each token and path spelled as a
    word of the synthetic vocabulary (``t<crc32 % tokens>``,
    ``p<crc32 % paths>``, the crc32 started at ``salt``): the source's
    context structure on words the model knows, where the extractor's own
    words are all out of it. The label is kept."""
    import zlib
    label, *contexts = line.split()
    out = [label]
    for context in contexts:
        src, path, tgt = context.split(',')
        out.append('t%d,p%d,t%d' % (
            zlib.crc32(src.encode(), salt) % sizes[0],
            zlib.crc32(path.encode(), salt) % sizes[1],
            zlib.crc32(tgt.encode(), salt) % sizes[0]))
    return ' '.join(out)


def repeat_profile(records, seconds: float, rate_scale: float,
                   sizes) -> list:
    """``records`` repeated back to back until their plan at
    ``rate_scale`` spans ``seconds``: each repeat's arrivals shifted past
    the one before by the profile's span plus its mean gap, its lines
    respelled under a salt of their own, so the mix and the pace stay the
    profile's and every request is new to the memo."""
    span = max(r['t'] for r in records)
    period = span + span / max(1, len(records) - 1)
    out = []
    for salt in range(math.ceil(seconds * rate_scale / period)):
        for record in records:
            out.append(dict(record, t=round(record['t'] + salt * period, 6),
                            lines=[respell(line, sizes, salt)
                                   for line in record['lines']]))
    return out


def mixed_profile(model, root: Path, binary: str, sizes) -> list:
    """``build_synthetic_profile`` over WORKLOADS_CLASSES Java and C#
    classes through the checkout's extractor, its lines respelled into the
    vocabulary, then every third record made a retrieval_naming blend
    (weight 0.5) and every fifth a neighbor_search query: all three entry
    kinds, both languages."""
    from code2vec_tpu_torch.workloads import profile as profile_lib
    records = profile_lib.build_synthetic_profile(
        model.config, str(root / 'corpus'),
        classes_per_language=WORKLOADS_CLASSES, seed=61,
        rate_rps=WORKLOADS_RATE_RPS, extractor_command=[binary])
    for i, record in enumerate(records):
        record['lines'] = [respell(line, sizes) for line in record['lines']]
        if i % 3 == 1:
            record.update(scenario='retrieval_naming', weight=0.5,
                          k=INDEX_K)
        elif i % 5 == 2:
            record.update(scenario='neighbor_search', k=INDEX_K)
    return records


def replay_results(mesh, records) -> list:
    """Each record of a profile through its entry point, one at a time
    (alone in its batch, so on the same bucket every run): its ranked
    words and scores."""
    from code2vec_tpu_torch.workloads.replay import _submit_one
    from code2vec_tpu_torch.workloads.scenario import get_scenario
    out = []
    for record in records:
        row = _submit_one(mesh, get_scenario(record['scenario']),
                          record).result(timeout=120)[0]
        if hasattr(row, 'predicted_words'):
            out.append((row.predicted_words, row.predicted_scores))
        elif hasattr(row, 'labels'):
            out.append((list(row.labels), np.asarray(row.scores)))
        else:
            out.append((row.topk_predicted_words,
                        row.topk_predicted_words_scores))
    return out


def single_line_ms(submit, lines) -> list:
    """Host ms of each single-line request, one at a time."""
    out = []
    for line in lines:
        t0 = time.perf_counter()
        submit([line]).result(timeout=120)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def await_rollover(mesh, handle, pool, what: str) -> float:
    """Drive neighbor queries of distinct pool lines until the rollover's
    handle is done; seconds from its arming to its conclusion."""
    t0 = time.perf_counter()
    for line in pool:
        if handle.done():
            break
        mesh.submit_neighbors([line], k=INDEX_K).result(timeout=120)
    wait_for(handle.done, 60.0, 'the %s rollover concluding' % what,
             'workloads')
    return time.perf_counter() - t0


def paced_replay(mesh, records, scale: float, timed, what: str,
                 gpu: str) -> None:
    """One paced open-loop replay of ``records`` at ``scale``, the memo's
    generation bumped first: the offered and delivered rates, the backlog
    at the window's middle and end, the drain; per scenario and language
    the requests, p50/p99 to completion, shed, exact, F1, memo hit rate;
    the graph replays; and, through ``timed`` (a ``TimedIndex`` or None),
    the searches each thread ran and its busiest thread's share of the
    window."""
    from code2vec_tpu_torch.workloads import replay as replay_lib
    if timed is not None:
        timed.reset()
    replays0 = total_replays(mesh)
    mesh._memo.bump_generation()
    report = replay_lib.replay(mesh, records, rate_scale=scale, seed=61,
                               pace=True, timeout_s=300.0)
    replays = total_replays(mesh) - replays0
    line = report['timeline']
    check(report['admitted'] == len(records) == line['sent']
          and report['fingerprint'] == replay_lib.admitted_fingerprint(
              replay_lib.plan_replay(records, rate_scale=scale, seed=61))
          and replays > 0, 'workloads: the paced plan at %g: %s, %d replays'
          % (scale, line, replays))
    delivered = 0
    for name, langs in sorted(report['scenarios'].items()):
        for language, cell in sorted(langs.items()):
            check(cell['delivered'] + cell['shed'] + cell['errors']
                  == cell['requests'] and cell['errors'] == 0,
                  'workloads: %s/%s %s' % (name, language, cell))
            delivered += cell['delivered']
            print('workloads paced x%g, %s index, %s/%s: %d requests, p50 '
                  '%.3f ms, p99 %.3f ms, shed %d, exact %.4f, F1 %.4f, memo '
                  'hit rate %.3f [%s]'
                  % (scale, what, name, language, cell['requests'],
                     cell['p50_ms'], cell['p99_ms'], cell['shed'],
                     cell['exact_match'], cell['f1'], cell['memo_hit_rate'],
                     gpu))
    searches = ''
    if timed is not None:
        by_kind = {}
        for thread, took in timed.seconds.items():
            by_kind.setdefault(thread.rsplit('_', 1)[0], []).append(took)
        searches = '; searches by thread kind (calls, total s, p50 ms, the ' \
            'busiest thread\'s share of the window): %s' % {
                kind: (sum(map(len, lists)), round(sum(map(sum, lists)), 4),
                       round(1e3 * statistics.median(
                           [t for one in lists for t in one]), 4),
                       round(max(map(sum, lists)) / line['window_s'], 4))
                for kind, lists in sorted(by_kind.items())}
    slo = report.get('slo') or {}
    print('workloads paced x%g (%.0f requests/s planned), %s index: %d '
          'records planned over %.2f s, sent over %.2f s: offered %.1f '
          'requests/s, delivered %.1f/s inside the window (%d), backlog %d '
          'at its middle and %d at its end, drained %.2f s after it; %d '
          'delivered, %d graph replays; SLO good %d, bad %d, slow %d%s [%s]'
          % (scale, WORKLOADS_RATE_RPS * scale, what, len(records),
             line['planned_s'], line['window_s'], line['offered_rps'],
             line['delivered_rps'], line['delivered_in_window'],
             line['backlog_mid'], line['backlog_end'], line['drain_s'],
             delivered, replays, slo.get('good_total', 0),
             slo.get('bad_total', 0), slo.get('slow_total', 0), searches,
             gpu))


def workloads_phase(model, gpu: str) -> dict:
    """The scenario traffic plane at java14m width (bf16, packed wire, the
    default ladder): a thread mesh of 2 replicas with the topk and vectors
    tiers, a 64 MiB memo and SLO targets on; an ``ExactIndex`` over the
    code vectors of INDEX_BULK_LINES lines from the bulk feed; a mixed
    Java and C# profile from ``build_synthetic_profile`` through the
    checkout's extractor, with all three entry kinds. The blend without an
    index (the typed fallback), at weight 0 (bit for bit ``topk``) and at
    0.5 (bit for bit ``blend_row`` over the request's own legs and the
    index's search); the profile replayed once through the traffic tap,
    saved and read back, then replayed unpaced twice at one seed (the same
    fingerprint and report cells) and one request at a time twice (bit
    for bit the same results); the profile repeated with fresh lines and
    paced for WORKLOADS_PACED_SECONDS at each of WORKLOADS_RATE_SCALES
    (the offer, the deliveries and the backlog; p50/p99, shed, exact and
    F1 per scenario and language; the searches each completion thread
    ran), then at the highest against ``InstantIndex`` (the control
    without searches); the blend's added latency against topk; index
    rollovers to an IVF candidate over the same rows, every list probed
    (it swaps: the neighbor entries go, the predict entries stay), to a
    disagreeing candidate (it rolls back) and to a raising one (its handle
    fails); no capture after warm-up; after ``close()`` this process's
    allocated bytes back within WORKLOADS_ALLOCATED_SLACK and the card's
    used bytes within MESH_MEMORY_SLACK, each measured with the cuBLAS
    workspaces released. Returns the ragged forward's wrapper launches of
    the mesh's warm-up and the mesh's graph replays."""
    import copy
    import dataclasses
    import torch
    from code2vec_tpu_torch.data.reader import canonicalize_contexts
    from code2vec_tpu_torch.index.exact import ExactIndex
    from code2vec_tpu_torch.index.ivf import IVFIndex
    from code2vec_tpu_torch.index.service import neighbors_from_search
    from code2vec_tpu_torch.serving import extractor_bridge
    from code2vec_tpu_torch.telemetry import core
    from code2vec_tpu_torch.workloads import blend as blend_lib
    from code2vec_tpu_torch.workloads import profile as profile_lib
    from code2vec_tpu_torch.workloads import replay as replay_lib
    started = time.perf_counter()
    rng = np.random.default_rng(60)
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    root = SMOKE_DIR / 'workloads'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    # the index: the bulk feed's code vectors, as index_phase builds them
    store, vectors32 = bulk_store(model, make_lines(
        rng, INDEX_BULK_LINES, sizes, model.config.MAX_CONTEXTS), root)
    exact = ExactIndex(store, device=DEVICE).warmup(INDEX_K)
    t0 = time.perf_counter()
    ivf = IVFIndex.build(store, persist=False, device=DEVICE)
    ivf.nprobe = ivf.n_clusters
    ivf_s = time.perf_counter() - t0
    # a disagreeing candidate: the same rows negated (cosine: the worst k)
    worst = ExactIndex(-vectors32, metric='cosine', labels=store.labels,
                       device=DEVICE)
    pool = make_lines(rng, 4 * WORKLOADS_LATENCY_LINES + 256, sizes,
                      model.config.MAX_CONTEXTS)
    t0 = time.perf_counter()
    binary = extractor_bridge.build_extractor()
    records = mixed_profile(model, root, binary, sizes)
    profile_s = time.perf_counter() - t0
    kinds = {(r['scenario'], r['language']) for r in records}
    check(len(records) >= 100 and {r['language'] for r in records}
          == {'java', 'csharp'} and {r['scenario'] for r in records}
          == {'java_naming', 'csharp_naming', 'retrieval_naming',
              'neighbor_search'},
          'workloads: the synthetic profile has %d records over %s'
          % (len(records), sorted(kinds)))
    print('workloads set-up: %d bulk lines -> a %d x %d float16 store; '
          'ExactIndex; IVF candidate of %d clusters (every list probed) '
          'built in %.2f s; the disagreeing candidate; the synthetic '
          'profile: %d Java and %d C# classes through the extractor -> %d '
          'records, %s, in %.2f s [%s]'
          % (INDEX_BULK_LINES, store.count, INDEX_DIM, ivf.n_clusters,
             ivf_s, WORKLOADS_CLASSES, WORKLOADS_CLASSES, len(records),
             {name: sum(r['scenario'] == name for r in records)
              for name in sorted({r['scenario'] for r in records})},
             profile_s, gpu))

    slo_model = copy.copy(model)
    slo_model.config = dataclasses.replace(
        model.config, SERVING_SLO_AVAILABILITY=0.99,
        SERVING_SLO_P99_MS=250.0)
    # the cuBLAS workspaces (one for each thread and stream that ran a
    # product, held in the caching allocator) are released at both ends
    torch._C._cuda_clearCublasWorkspaces()
    used0 = card_used_bytes()
    allocated0 = torch.cuda.memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    core.reset()
    core.enable()
    mesh = None
    try:
        zero_counts()
        mesh = slo_model.serving_mesh(replicas=MESH_REPLICAS,
                                      tiers=('topk', 'vectors'),
                                      memo_cache_bytes=MESH_MEMO_BYTES,
                                      max_delay_ms=2.0)
        warm = mesh_warm(mesh, gpu, 'workloads')
        launches = launch_counts()['ragged_fwd']
        # each key: one eager run, then one capture a slot
        check(launches == sum(warm['captures'])
              + warm['keys'] * MESH_REPLICAS,
              'workloads mesh warm-up: %d ragged_fwd launches for %d keys x '
              '%d replicas, captures %s' % (launches, warm['keys'],
                                            MESH_REPLICAS, warm['captures']))
        memo = mesh._memo
        reg = core.registry()

        # the blend with no index: the typed fallback
        fallback = mesh.submit_blended(pool[:4]).result(timeout=120)
        check([r.source for r in fallback] == [blend_lib.SOURCE_FALLBACK] * 4
              and reg.counter('mesh/blend_fallback_total').value == 1,
              'workloads: the blend with no index is not the fallback')
        mesh.attach_index(exact)
        # weight 0: bit for bit the live topk (the memo's generation bumped
        # between, so both run live)
        batch = pool[4:12]
        wrapped = mesh.submit_blended(batch, weight=0.0).result(timeout=120)
        memo.bump_generation()
        plain = mesh.submit(batch, tier='topk').result(timeout=120)
        check(all(r.source == blend_lib.SOURCE_SOFTMAX for r in wrapped)
              and result_diff([r.base for r in wrapped], plain,
                              'blend weight 0') == 0
              and all(np.array_equal(r.predicted_scores,
                                     p.topk_predicted_words_scores)
                      for r, p in zip(wrapped, plain)),
              'workloads: the weight-0 blend differs from topk')
        # weight 0.5: bit for bit blend_row over the request's own legs
        # and the index's own search
        batch = pool[12:20]
        blended = mesh.submit_blended(batch, weight=0.5,
                                      k=INDEX_K).result(timeout=120)
        base = mesh.submit(batch, tier='topk').result(timeout=120)
        vecs = np.stack([r.code_vector for r in mesh.submit(
            batch, tier='vectors').result(timeout=120)])
        values, indices = exact.search(vecs, INDEX_K)
        nbrs = neighbors_from_search(values, indices, exact.labels)
        want = [blend_lib.blend_row(b, n, 0.5) for b, n in zip(base, nbrs)]
        check(all(g.source == blend_lib.SOURCE_BLEND
                  and g.predicted_words == w.predicted_words
                  and np.array_equal(g.predicted_scores, w.predicted_scores)
                  and np.isfinite(g.predicted_scores).all()
                  for g, w in zip(blended, want)),
              'workloads: the 0.5 blend differs from blend_row')
        moved = sum(g.predicted_words[0] != b.topk_predicted_words[0]
                    for g, b in zip(blended, base))
        print('workloads blend: no index -> %s (mesh/blend_fallback_total '
              '1); weight 0 bit for bit topk on %d lines, both live; weight '
              '0.5 at k=%d bit for bit blend_row over the request\'s topk '
              'rows and the ExactIndex\'s search of its vectors on %d lines '
              '(the top word moved on %d) [%s]'
              % (blend_lib.SOURCE_FALLBACK, len(plain), INDEX_K, len(batch),
                 moved, gpu))

        # the profile through the traffic tap, saved and read back
        recorder = profile_lib.ProfileRecorder()
        mesh.record_traffic(recorder)
        try:
            first = replay_lib.replay(mesh, records, pace=False,
                                      timeout_s=300.0)
        finally:
            mesh.record_traffic(None)
        path = str(root / 'recorded.jsonl')
        saved = recorder.save(path, meta={'gpu': gpu})
        _header, loaded = profile_lib.read_profile(path)
        first_delivered = sum(c['delivered'] for cells
                              in first['scenarios'].values()
                              for c in cells.values())
        check(saved == len(records) == len(loaded) == first_delivered
              and recorder.dropped == 0
              and [(r['scenario'], r.get('language'), r['lines'],
                    r.get('k'), r.get('weight')) for r in loaded]
              == [(r['scenario'], r['language'], canonicalize_contexts(
                  r['lines'], model.config.MAX_CONTEXTS), r.get('k'),
                   r.get('weight')) for r in records],
              'workloads: the tap recorded %d of %d requests (%d delivered)'
              % (saved, len(records), first_delivered))
        # replayed twice at one seed, unpaced, the memo's generation
        # bumped before each so both run live: the same admitted set (the
        # fingerprint) and the same report cells
        reps = []
        for _ in range(2):
            memo.bump_generation()
            reps.append(replay_lib.replay(mesh, loaded, seed=61, pace=False,
                                          timeout_s=300.0))
        plan = replay_lib.plan_replay(loaded, seed=61)
        fingerprint = replay_lib.admitted_fingerprint(plan)
        cells = [{(name, language): tuple(cell[key]
                                          for key in WORKLOADS_CELL_FIELDS)
                  for name, langs in rep['scenarios'].items()
                  for language, cell in langs.items()} for rep in reps]
        check(reps[0]['fingerprint'] == reps[1]['fingerprint']
              == fingerprint and reps[0]['admitted'] == len(loaded)
              and cells[0] == cells[1],
              'workloads: two unpaced replays at one seed differ: %s, %s'
              % (reps[0]['fingerprint'][:16], reps[1]['fingerprint'][:16]))
        # and one request at a time (alone in its batch, so on the same
        # bucket every run): every result bit for bit
        runs = []
        for _ in range(2):
            memo.bump_generation()
            t0 = time.perf_counter()
            runs.append(replay_results(mesh, [r for _t, r in plan]))
            runs[-1].append(time.perf_counter() - t0)
        differ = sum(list(a[0]) != list(b[0]) or not np.array_equal(a[1],
                                                                    b[1])
                     for a, b in zip(runs[0][:-1], runs[1][:-1]))
        check(differ == 0 and all(np.isfinite(scores).all()
                                  for _w, scores in runs[0][:-1]),
              'workloads: %d of %d replayed results differ between runs'
              % (differ, len(plan)))
        print('workloads record and replay: %d requests replayed through '
              'the tap (one record each, none dropped), saved, read back; '
              'replay(pace=False) twice at seed 61: fingerprint %s both '
              'times, every cell\'s %s equal (%.2f s, %.2f s); one request '
              'at a time twice, live: every result bit for bit equal '
              '(%.2f s, %.2f s) [%s]'
              % (saved, fingerprint[:16], '/'.join(WORKLOADS_CELL_FIELDS),
                 reps[0]['timeline']['window_s'],
                 reps[1]['timeline']['window_s'], runs[0][-1], runs[1][-1],
                 gpu))

        # paced, open loop, WORKLOADS_PACED_SECONDS at each rate scale: the
        # synthetic profile repeated with fresh lines; the offer, the
        # deliveries and the backlog, the report per scenario and language,
        # and the searches each completion thread ran. Then the highest
        # rate again against InstantIndex, the control without searches
        timed = TimedIndex(exact)
        mesh.attach_index(timed)
        for scale in WORKLOADS_RATE_SCALES:
            paced_replay(mesh, repeat_profile(
                records, WORKLOADS_PACED_SECONDS, scale, sizes), scale,
                timed, 'exact', gpu)
        mesh.attach_index(InstantIndex(exact, vectors32[0], INDEX_K))
        paced_replay(mesh, repeat_profile(
            records, WORKLOADS_PACED_SECONDS, WORKLOADS_RATE_SCALES[-1],
            sizes), WORKLOADS_RATE_SCALES[-1], None, 'instant (control)',
            gpu)
        mesh.attach_index(exact)

        # the blend's added latency: single distinct lines, live
        memo.bump_generation()
        sample = pool[20:20 + 2 * WORKLOADS_LATENCY_LINES]
        topk_ms = single_line_ms(lambda l: mesh.submit(l, tier='topk'),
                                 sample[::2])
        blend_ms = single_line_ms(
            lambda l: mesh.submit_blended(l, weight=0.5, k=INDEX_K),
            sample[1::2])
        print('workloads blend latency (single lines, live, %d each, max '
              'delay 2 ms): topk p50 %.3f ms, p99 %.3f ms; blend 0.5 p50 '
              '%.3f ms, p99 %.3f ms; added p50 %.3f ms [%s]'
              % (WORKLOADS_LATENCY_LINES, statistics.median(topk_ms),
                 float(np.percentile(topk_ms, 99)),
                 statistics.median(blend_ms),
                 float(np.percentile(blend_ms, 99)),
                 statistics.median(blend_ms) - statistics.median(topk_ms),
                 gpu))

        # index rollovers: to the IVF candidate (swap), to the negated
        # rows (rollback), to a raising candidate (its handle fails). After
        # the swap the neighbor probe misses (its vectors leg hits) and the
        # predict probe hits
        rollover_pool = iter(pool[20 + 2 * WORKLOADS_LATENCY_LINES:])
        probe_n, probe_p = pool[0:1], pool[1:2]
        mesh.submit_neighbors(probe_n, k=INDEX_K).result(timeout=120)
        mesh.submit(probe_p, tier='topk').result(timeout=120)
        stats0 = mesh.stats()
        handle = mesh.rollover_index(ivf, shadow_queries=WORKLOADS_SHADOW,
                                     min_agreement=0.9)
        swap_s = await_rollover(mesh, handle, rollover_pool, 'IVF')
        report = handle.result()
        stats1 = mesh.stats()
        hits0, misses0 = stats1['memo']['hits'], stats1['memo']['misses']
        mesh.submit_neighbors(probe_n, k=INDEX_K).result(timeout=120)
        mesh.submit(probe_p, tier='topk').result(timeout=120)
        stats2 = mesh.stats()
        check(report['swapped'] and mesh._index is ivf
              and stats1['index_version'] == stats0['index_version'] + 1
              and stats1['memo']['index_generation']
              == stats0['memo']['index_generation'] + 1
              and stats2['memo']['misses'] == misses0 + 1
              and stats2['memo']['hits'] == hits0 + 2,
              'workloads: the IVF rollover %s; memo %s -> %s'
              % (report, stats1['memo'], stats2['memo']))
        handle = mesh.rollover_index(worst, shadow_queries=WORKLOADS_SHADOW,
                                     min_agreement=0.9)
        rollback_s = await_rollover(mesh, handle, rollover_pool, 'negated')
        rollback = handle.result()
        stats3 = mesh.stats()
        check(not rollback['swapped'] and mesh._index is ivf
              and stats3['index_version'] == stats1['index_version']
              and stats3['memo']['index_generation']
              == stats1['memo']['index_generation'],
              'workloads: the disagreeing rollover %s' % rollback)
        handle = mesh.rollover_index(BoomIndex(), shadow_queries=1)
        await_rollover(mesh, handle, rollover_pool, 'raising')
        error = handle.exception()
        stats4 = mesh.stats()
        check(isinstance(error, RuntimeError) and mesh._index is ivf
              and stats4['index_rollover_total'] == 1
              and stats4['index_rollover_rollbacks_total'] == 2,
              'workloads: the raising rollover: %r, stats %s'
              % (error, {k: stats4[k] for k in (
                  'index_version', 'index_rollover_total',
                  'index_rollover_rollbacks_total')}))
        print('workloads index rollover: to the IVF candidate (%d clusters, '
              'every list probed) swapped at agreement %.4f over %d shadow '
              'queries in %.3f s (index version %d; the neighbor entry '
              'missed, its vectors leg and the predict entry hit); to the '
              'negated rows rolled back at agreement %.4f in %.3f s; the '
              'raising candidate '
              'failed its handle (%s); index/rollover_agreement %.4f [%s]'
              % (ivf.n_clusters, report['agreement'], report['queries'],
                 swap_s, report['index_version'], rollback['agreement'],
                 rollback_s, error,
                 reg.gauge('index/rollover_agreement').value, gpu))

        for replica in mesh.replica_stats():
            check(replica['graph_captures_after_warmup'] == 0,
                  'workloads: replica %s captured after warm-up'
                  % replica['replica'])
        check(launch_counts()['ragged_fwd'] == launches,
              'workloads: %d ragged_fwd wrapper launches after the warm-up'
              % (launch_counts()['ragged_fwd'] - launches))
    finally:
        if mesh is not None:
            mesh.close()
        core.disable()
        core.reset()
    replays = total_replays(mesh)
    del mesh
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    used_end = card_used_bytes()
    allocated = torch.cuda.memory_allocated() - allocated0
    reserved = torch.cuda.memory_reserved() - reserved0
    check(allocated <= WORKLOADS_ALLOCATED_SLACK
          and used_end - used0 <= MESH_MEMORY_SLACK,
          'workloads: after close() %+d bytes allocated (slack %d), the '
          'card %+d (slack %d)' % (allocated, WORKLOADS_ALLOCATED_SLACK,
                                   used_end - used0, MESH_MEMORY_SLACK))
    del exact, ivf, worst, store
    shutil.rmtree(root, ignore_errors=True)
    print('workloads closed: %+d bytes allocated from before the mesh '
          '(slack %d), %+d reserved, the card %+d (slack %d), the cuBLAS '
          'workspaces released; captures after warm-up 0; ragged_fwd '
          'wrapper launches %d (the warm-up), graph replays %d [%s]'
          % (allocated, WORKLOADS_ALLOCATED_SLACK, reserved,
             used_end - used0, MESH_MEMORY_SLACK, launches, replays, gpu))
    print('workloads phase: %.1f s' % (time.perf_counter() - started))
    return {'launches': launches, 'replays': replays}


# --------------------------------------------------- the (data, model) mesh
MESH_SHAPE = (2, 2)
MESH_TRAIN_LINES = 4096          # 4 steps of 1024 an epoch
MESH_TRAIN_EPOCHS = 2
MESH_EVAL_LINES = 2048           # 2 eval steps of 1024
MESH_ROUTE_REPS = 2              # timed repetitions of each route
MESH_PAD_VALID = 100000          # num_valid leaving target shard 1 padding
MESH_DEADLINE_S = 600.0
# the mesh route against the one-rank route on one global batch (bf16,
# the error over the largest |value| of each tensor): the code vectors
# and the CE sum; the encoder's gradients (fp32, summed in another
# order); the CE's gradients, which come back rounded to bf16: one bf16
# step of the largest value (2^-7 at the top of a binade); the eval
# step's top-1 agreement
MESH_CODE_LIMIT = 1e-4
MESH_GRAD_LIMIT = 2e-3
MESH_CE_GRAD_LIMIT = 2.0 ** -7
MESH_TOP1_LIMIT = 0.95
# each route on its kernels against the same route on the kernels' plain
# versions (bf16): the code and attention within the ragged forward's
# atol 1e-2, the encoder's gradients within the ragged backward's scaled
# 1e-3, lse and picked within the CE forward's rtol/atol 1e-4, the CE's
# gradients (returned in bf16) within one bf16 step of the largest
MESH_PLAIN_LIMITS = {'b7_stats': 1e-2, 'b7_grads': 1e-3,
                     'b7_ce_bwd': 2.0 ** -7, 'b7_ce_sums': 2.0 ** -7}
# (key, name, route source, the reference function it replaces, the
# kernels the route launches: its record's ``launches`` are the first's, on
# the main path of every rank, where every launch of them is the route's)
B7_ROUTES = (
    ('b7_stats', 'sharded_stats (B7a)', 'code2vec_tpu_torch/ops/ragged.py',
     'code2vec_tpu/ops/pallas_ragged.py:259', ('ragged_fwd', 'gather')),
    ('b7_grads', 'sharded_grads (B7b)', 'code2vec_tpu_torch/ops/ragged.py',
     'code2vec_tpu/ops/pallas_ragged.py:626', ('ragged_bwd',)),
    ('b7_ce_fwd', 'sharded_ce_forward (B7c)', 'code2vec_tpu_torch/ops/ce.py',
     'code2vec_tpu/ops/pallas_ce.py:326', ('ce_fwd',)),
    ('b7_ce_bwd', 'sharded_ce_backward (B7d)', 'code2vec_tpu_torch/ops/ce.py',
     'code2vec_tpu/ops/pallas_ce.py:372', ('ce_bwd',)),
    ('b7_ce_sums', 'sharded_ce_sums (B7e)', 'code2vec_tpu_torch/ops/ce.py',
     'code2vec_tpu/ops/pallas_ce.py:407', ('ce_fwd', 'ce_bwd')))


# the training knobs on the mesh (``mesh_knob_checks``). SHARD_CONTEXTS
# against the unsharded route on one batch and keep mask (bf16): the two
# normalize the softmax in other fp32 orders (z summed over the split
# contexts, its gradient through a division instead of the softmax's
# backward), so a value rounded to bf16 after it (an attention weight, a
# score's gradient) may land one bf16 step apart, up to 2^-7 of the
# largest value at the bottom of its binade: the code within one step of
# its scale, the encoder's gradients (a table row sums several contexts'
# bf16 products) within two; the loss relatively
MESH_SHARD_LIMITS = {'code': 2.0 ** -7, 'grads': 2.0 ** -6}
MESH_SHARD_LOSS_LIMIT = 1e-4
MESH_LONG_CONTEXTS = 1024        # the long bag of the SHARD_CONTEXTS step
MESH_ZERO_STEPS = 4
# lazy Adam against one rank over as many steps as the train reference
# whose update-norm limit it takes (RESUME_LIMITS): a first Adam step
# moves an element by lr times the sign of its gradient, so one gradient
# near zero whose sign two summation orders disagree on reads
# 2 / sqrt(147,456) = 5.2e-3 on the transform alone (PERF.md)
MESH_LAZY_STEPS = 3
MESH_FP32_LINES = 2048           # two fp32 train() steps of 1024
# fp32 routes against the one-rank fp32 route and their plain versions:
# fp32 sums in other orders (the kernels' tiles, the merges), ~1e-6 of a
# tensor's scale; a wrong row or tile reads at the full scale
MESH_FP32_LIMITS = {'code': 1e-5, 'grads': 1e-4}
MESH_FP32_GATHER_LIMIT = 2.0 ** -22    # one fp32 rounding of e / keep
# the knobs' records: (key, name, source, the function it replaces)
KNOB_ROUTES = (
    ('fp32_stats', 'sharded_stats fp32 (B7a)',
     'code2vec_tpu_torch/ops/ragged.py',
     'code2vec_tpu/ops/pallas_ragged.py:259'),
    ('fp32_grads', 'sharded_grads fp32 (B7b)',
     'code2vec_tpu_torch/ops/ragged.py',
     'code2vec_tpu/ops/pallas_ragged.py:626'),
    ('slice_encode', 'fused_context_transform on a context slice '
     '(SHARD_CONTEXTS)', 'code2vec_tpu_torch/ops/csrc/encode.cu',
     'code2vec_tpu/ops/pallas_encode.py:64'),
    ('mesh_rows', 'adam_rows on the mesh (lazy Adam)',
     'code2vec_tpu_torch/ops/csrc/adam.cu',
     'code2vec_tpu/ops/lazy_adam.py:65'))


def mesh_launch_counts() -> dict:
    """The kernel wrappers' launch counts, the mesh's gather included."""
    from code2vec_tpu_torch.ops import ragged
    counts = launch_counts()
    counts['gather'] = ragged.gather_launches
    return counts


def zero_mesh_counts() -> None:
    from code2vec_tpu_torch.ops import ragged
    zero_counts()
    ragged.gather_launches = 0


class PlainRoutes:
    """Inside the block, every kernel wrapper the mesh routes call runs its
    plain version, on the card: the routes' plain times."""

    def __enter__(self):
        from code2vec_tpu_torch.ops import ce, ragged
        self.saved = [(ragged, '_gather_range_kernel'),
                      (ragged, '_stats_kernel'), (ragged, '_grads_kernel'),
                      (ce, '_lse_pick_kernel'), (ce, '_ce_grads_kernel')]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]

        def stats(tok, path, trans, attn, segs, tpad, ppad, keep=None,
                  keep_rate=1.0, e=None):
            if e is not None:
                return ragged._stats_from_e_plain(e, trans, attn, segs)
            return ragged._stats_plain(tok, path, trans, attn, segs, tpad,
                                       ppad, keep, keep_rate)

        def grads(*args, token_pad, path_pad, e=None):
            return ragged._grads_plain(*args, e=e)
        ragged._gather_range_kernel = ragged._gather_range_plain
        ragged._stats_kernel = stats
        ragged._grads_kernel = grads
        ce._lse_pick_kernel = ce._lse_pick_plain
        ce._ce_grads_kernel = ce._ce_grads_plain
        return self

    def __exit__(self, *exc):
        for module, name, value in self.saved:
            setattr(module, name, value)


def mesh_global_batch(vocabs, seed: int):
    """The global batch of the route checks (the same on every rank): 1024
    java14m-fill examples packed in 2 data shards, labels over the real
    targets, weight 0 on the empty rows."""
    from code2vec_tpu_torch.data import packed as packed_lib
    rng = np.random.default_rng(seed)
    tpad = vocabs.token_vocab.pad_index
    ppad = vocabs.path_vocab.pad_index
    plane = plane_batch(rng, 1024, 200, vocabs.token_vocab.size,
                        vocabs.path_vocab.size, tpad, ppad)
    plane = plane._replace(
        label=rng.integers(1, vocabs.target_vocab.size, 1024).astype(
            np.int32),
        weight=(plane.mask.sum(axis=1) > 0).astype(np.float32))
    return packed_lib.pack_batch(plane, tpad, ppad,
                                 data_shards=MESH_SHAPE[0])


def timed_ms(fn, reps: int = MESH_ROUTE_REPS) -> float:
    """Median ms of ``fn()`` by CUDA events (collectives included); by the
    host clock off the card (a rehearsal)."""
    import torch
    fn()
    times = []
    if DEVICE == 'cpu':
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tensor_sha(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(
            __import__('torch').uint8).numpy().tobytes())
    return h.hexdigest()


def state_digests(params: dict, moments: dict, target_rows: int) -> tuple:
    """Digests of a state's params and Adam moments ({name: tensor} each,
    moments {'mu': ..., 'nu': ...}), the target table cut to
    ``target_rows`` (the masked padding rows that follow them depend on
    the model axis' allocation)."""
    def cut(named):
        return [named[name][:target_rows] if name == 'target_embedding'
                else named[name] for name in sorted(named)]
    return (tensor_sha(cut(params)),
            tensor_sha(cut(moments['mu']) + cut(moments['nu'])))


def mesh_route_checks(mesh, vocabs, config, device) -> dict:
    """Each B7 route on this rank against the one-rank route on the same
    global batch (bf16, the fp32 masters, a keep mask of 0.75 shared by
    both), the sharded CE kernels against their plain versions on an
    all-padding shard, ``sharded_top_k`` against ``top_k`` on the same
    logits, and each route's times."""
    import torch
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.ops import ce, ragged
    from code2vec_tpu_torch.ops.topk import sharded_top_k, top_k
    from code2vec_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from code2vec_tpu_torch.training.trainer import Trainer
    out = {}
    bf16 = torch.bfloat16
    # one rank's backend at the mesh's allocation (the target rows grow
    # with the model axis under the fused CE)
    full = TorchBackend(config, vocabs, device, seed=1)
    local = TorchBackend(config, vocabs, device, params=full.params,
                         mesh=mesh)
    packed = mesh_global_batch(vocabs, 20)
    d, m = mesh.data_index, mesh.model_index
    per = 1024 // mesh.data
    rows = slice(d * per, (d + 1) * per)
    cat = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    g_ctx, g_count = cat(packed.ctx), cat(packed.count)
    label, weight = cat(packed.label), cat(packed.weight)
    l_ctx = g_ctx[d:d + 1].contiguous()
    l_count = g_count[rows].contiguous()
    tpad, ppad = full.token_pad_index, full.path_pad_index
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    context_dim = full.transform.shape[0]
    keep = torch.rand(g_ctx.shape[:2] + (context_dim,), generator=gen,
                      device=device) < 0.75
    g_cot = torch.randn((1024, full.transform.shape[1]), generator=gen,
                        device=device)
    kw = dict(token_pad=tpad, path_pad=ppad, dtype=bf16, keep_rate=0.75)

    def encode(backend, ctx, count, mask, msh, cot):
        params = [p.detach().clone().requires_grad_()
                  for p in (backend.token_embedding, backend.path_embedding,
                            backend.transform, backend.attention)]
        code = ragged.ragged_encode_code(*params, ctx, count,
                                         keep_mask=mask, mesh=msh, **kw)
        (code * cot).sum().backward()
        return code.detach(), [p.grad for p in params]

    one_code, one_grads = encode(full, g_ctx, g_count, keep, None, g_cot)
    mesh_code, mesh_grads = encode(local, l_ctx, l_count, keep[d:d + 1],
                                   mesh, g_cot[rows])
    tok_rows = slice(*mesh.row_range(full.token_embedding.shape[0]))
    path_rows = slice(*mesh.row_range(full.path_embedding.shape[0]))
    out['code_err'] = scaled_err([mesh_code], [one_code[rows]])
    out['encode_grad_err'] = scaled_err(
        mesh_grads, [one_grads[0][tok_rows], one_grads[1][path_rows],
                     one_grads[2], one_grads[3]])
    del one_grads, mesh_grads
    # the CE tail on the encoder's code vectors
    code = one_code.detach()
    num_valid = full.num_valid_targets

    def ce_route(backend, code_in, lab, wt, msh, nv):
        target = backend.target_embedding.detach().clone().requires_grad_()
        code_in = code_in.clone().requires_grad_()
        if msh is None:
            ce_sum, w_sum = ce.fused_weighted_ce_sums(
                target, code_in, lab, wt, nv, dtype=bf16)
            total = w_sum
        else:
            ce_sum, w_sum = ce.sharded_fused_weighted_ce_sums(
                target, code_in, lab, wt, nv, msh, dtype=bf16)
            total = msh.all_reduce(w_sum.detach().clone(), DATA_AXIS)
        (ce_sum / total).backward()
        return ce_sum.detach(), target.grad, code_in.grad

    one_ce, one_dw, one_dcode = ce_route(full, code, label, weight, None,
                                         num_valid)
    got_ce, got_dw, got_dcode = ce_route(local, code[rows], label[rows],
                                         weight[rows], mesh, num_valid)
    got_ce = mesh.all_reduce(got_ce.clone(), DATA_AXIS)
    tgt_rows = slice(*mesh.row_range(full.target_embedding.shape[0]))
    out['ce_err'] = abs(float(got_ce) - float(one_ce)) / abs(float(one_ce))
    out['ce_grad_err'] = scaled_err([got_dw, got_dcode],
                                    [one_dw[tgt_rows], one_dcode[rows]])
    del one_dw, got_dw
    # the sharded CE kernels against their plain versions where shard 1
    # holds padding alone (num_valid < V/M): a finite merged lse, exactly
    # zero gradient rows on the padding shard
    w_local = local.target_embedding.detach().to(bf16)
    c_local = code[rows].to(bf16)
    label_l, nv = ce.shard_labels(label[rows], MESH_PAD_VALID,
                                  w_local.shape[0], m)
    lse_k, pick_k = ce._lse_pick_kernel(c_local, w_local, label_l, nv)
    lse_p, pick_p = ce._lse_pick_plain(c_local, w_local, label_l, nv)
    from code2vec_tpu_torch.parallel.mesh import merge_lse
    merged_k, merged_p = merge_lse(lse_k, mesh), merge_lse(lse_p, mesh)
    check(bool(torch.isfinite(merged_k).all()),
          'a non-finite merged lse with a padding-only shard')
    out['pad_lse_err'] = max_err([merged_k], [merged_p])
    if nv == 0:
        check(bool((lse_k <= -1e29).all()) and bool((lse_p <= -1e29).all())
              and float(pick_k.abs().max()) == 0.0
              and float(pick_p.abs().max()) == 0.0,
              'a padding-only shard gave an lse above -1e29 or a pick')
    dl = torch.full_like(merged_k, 1.0 / 1024)
    dw_k, dc_k = ce._ce_grads_kernel(c_local, w_local, label_l, merged_k, dl,
                                     -dl, nv)
    dw_p, dc_p = ce._ce_grads_plain(c_local, w_local, label_l, merged_p, dl,
                                    -dl, nv)
    if nv == 0:
        check(float(dw_k.abs().max()) == 0.0 and float(dc_k.abs().max())
              == 0.0 and float(dw_p.abs().max()) == 0.0,
              'a padding-only shard has a non-zero gradient')
    out['pad_grad_err'] = scaled_err([dw_k, dc_k], [dw_p, dc_p])
    out['pad_shard_valid'] = nv
    del dw_k, dw_p
    # the gather kernel with a row range against its plain version on this
    # rank's table slices: bit for bit (a copy, a rounding, the mask)
    segs = ragged._segment_inputs(l_ctx, l_count, tpad, ppad)
    lo_t = mesh.row_range(full.token_embedding.shape[0])[0]
    lo_p = mesh.row_range(full.path_embedding.shape[0])[0]
    gather_args = (local.token_embedding.detach(),
                   local.path_embedding.detach(), segs, bf16, keep[d:d + 1],
                   0.75, lo_t, lo_p)
    e_kernel = ragged._gather_range_kernel(*gather_args)
    e_plain = ragged._gather_range_plain(*gather_args)
    check(torch.equal(e_kernel, e_plain),
          'the gather kernel differs from its plain version (max |diff| '
          '%.3g)' % max_err([e_kernel], [e_plain]))
    out['gather_rows'] = int(e_kernel.shape[1])
    del e_kernel, e_plain, segs
    # the eval step's top k: the mesh against one rank, and sharded_top_k
    # against top_k on the same logits (index for index)
    one_trainer = Trainer(config, full)
    mesh_trainer = Trainer(config, local, mesh=mesh)
    one_out = one_trainer.eval_step_placed((g_ctx, g_count, label, weight))
    mesh_out = mesh_trainer.eval_step_placed((l_ctx, l_count, label[rows],
                                              weight[rows]))
    valid = weight[rows] > 0
    same = (mesh_out['topk_indices'][:, 0] ==
            one_out['topk_indices'][rows][:, 0])[valid]
    out['top1_agree'] = float(same.float().mean())
    logits = full.logits(full.encode_packed(g_ctx[d:d + 1], l_count)[0])
    width = logits.shape[1] // mesh.model
    sv, si = sharded_top_k(logits[:, m * width:(m + 1) * width].contiguous(),
                           10, mesh)
    tv, ti = top_k(logits, 10)
    check(torch.equal(si, ti) and torch.equal(sv, tv),
          'sharded_top_k differs from top_k on the same logits')
    del logits, one_out, mesh_out
    # the routes' times on this rank (collectives included) and their
    # plain versions on the card
    comp = local.compute_params
    e_rows = int(l_ctx.shape[1])
    mask_l = keep[d:d + 1]

    def stats_route():
        ragged.ragged_encode(comp.token_embedding, comp.path_embedding,
                             comp.transform, comp.attention, l_ctx, l_count,
                             max_contexts=200, token_pad=tpad,
                             path_pad=ppad, dtype=bf16, mesh=mesh)

    def grads_route():
        encode(local, l_ctx, l_count, mask_l, mesh, g_cot[rows])

    target = local.target_embedding.detach().clone().requires_grad_()
    c_req = code[rows].clone().requires_grad_()

    def ce_fwd_route():
        with torch.no_grad():
            ce.sharded_fused_lse_and_pick(c_local, w_local, label[rows],
                                          num_valid, mesh)

    ce_sum, _w = ce.sharded_fused_weighted_ce_sums(
        target, c_req, label[rows], weight[rows], num_valid, mesh,
        dtype=bf16)

    def ce_bwd_route():
        torch.autograd.grad(ce_sum, [target, c_req], retain_graph=True)

    def ce_sums_route():
        s, _ = ce.sharded_fused_weighted_ce_sums(
            target, c_req, label[rows], weight[rows], num_valid, mesh,
            dtype=bf16)
        torch.autograd.grad(s, [target, c_req])

    routes = {'b7_stats': stats_route, 'b7_grads': grads_route,
              'b7_ce_fwd': ce_fwd_route, 'b7_ce_bwd': ce_bwd_route,
              'b7_ce_sums': ce_sums_route}
    out['ms'] = {k: timed_ms(fn) for k, fn in routes.items()}
    with PlainRoutes():
        out['plain_ms'] = {k: timed_ms(fn, reps=2)
                           for k, fn in routes.items()}

    # each route against its plain version on the same inputs
    def route_outputs():
        with torch.no_grad():
            code_, attn_ = ragged.ragged_encode(
                comp.token_embedding, comp.path_embedding, comp.transform,
                comp.attention, l_ctx, l_count, max_contexts=200,
                token_pad=tpad, path_pad=ppad, dtype=bf16, mesh=mesh)
            lse_, pick_ = ce.sharded_fused_lse_and_pick(
                c_local, w_local, label[rows], num_valid, mesh)
        grads_ = encode(local, l_ctx, l_count, mask_l, mesh, g_cot[rows])[1]
        sum_, dw_, dc_ = ce_route(local, code[rows], label[rows],
                                  weight[rows], mesh, num_valid)
        return [code_, attn_], grads_, [lse_, pick_], [dw_, dc_], sum_

    got = route_outputs()
    with PlainRoutes():
        want = route_outputs()
    check(all(bool(torch.isfinite(t).all()) for t in got[0] + got[1]
              + got[2] + got[3]), 'a mesh route gave a non-finite output')
    sum_err = abs(float(got[4]) - float(want[4])) / abs(float(want[4]))
    out['plain_err'] = {
        'b7_stats': max_err(got[0], want[0]),
        'b7_grads': scaled_err(got[1], want[1]),
        'b7_ce_fwd': max_err(got[2], want[2]),
        'b7_ce_bwd': scaled_err(got[3], want[3]),
        'b7_ce_sums': worst(sum_err, scaled_err(got[3], want[3]))}
    out['lse_scale'] = float(want[2][0].abs().max())
    del got, want
    # the least time of each route's work on this rank (the table slice,
    # the data shard): bytes over the memory rate, products over the bf16
    # peak
    n = int(l_count.sum())
    k_dim, d_code = context_dim, full.transform.shape[1]
    vm, bd = w_local.shape[0], per
    token_dim = full.token_embedding.shape[1]
    stream = n * k_dim * 2
    out['bound'] = {
        'b7_stats': bound(n * 3 * 4 + n * (2 * token_dim + token_dim) * 4
                       / mesh.model + 2 * stream + k_dim * d_code * 2
                       + per * (d_code + 2) * 4,
                       2.0 * n * k_dim * d_code, 'bfloat16'),
        'b7_grads': bound(stream + n * k_dim * 4 + 2 * n * d_code * 2
                       + k_dim * d_code * 4,
                       6.0 * n * k_dim * d_code, 'bfloat16'),
        'b7_ce_fwd': bound(vm * d_code * 2 + bd * d_code * 2 + bd * 12,
                        2.0 * bd * vm * d_code, 'bfloat16'),
        'b7_ce_bwd': bound(vm * d_code * (2 + 4) + bd * d_code * (2 + 4),
                        6.0 * bd * vm * d_code, 'bfloat16'),
        'b7_ce_sums': bound(vm * d_code * (2 + 2 + 4) + bd * d_code * 6,
                         8.0 * bd * vm * d_code, 'bfloat16')}
    out['slots'] = n
    out['e_rows'] = e_rows
    del full, local, one_trainer, mesh_trainer, target, c_req, ce_sum
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return out


def slice_readings(got, want, start) -> dict:
    """A mesh rank's state against the one-rank state's same rows, in
    float64: each parameter's update error ||got - want|| / ||want -
    start|| (the worst) and each moment's ``scaled``, ``rel`` and
    ``scale`` (``moment_readings``' keys, the worst over its tensors).
    ``got``, ``want``: {'params': [...], 'mu': [...], 'nu': [...]}."""
    out = {'weights': 0.0, 'by_param': []}
    for g, w, s in zip(got['params'], want['params'], start):
        g, w, s = g.double(), w.double(), s.double()
        moved = max(float(((w - s) ** 2).sum()), 1e-300)
        reading = math.sqrt(float(((g - w) ** 2).sum()) / moved)
        out['by_param'].append(reading)
        out['weights'] = worst(out['weights'], reading)
    for moment in ('mu', 'nu'):
        readings = {'scaled': 0.0, 'rel': 0.0, 'scale': 0.0}
        for g, w in zip(got[moment], want[moment]):
            g, w = g.double(), w.double()
            if not bool(w.any()):
                # a shard of padding rows alone: zero moments on both sides
                off = 0.0 if not bool(g.any()) else math.inf
                for key in readings:
                    readings[key] = worst(readings[key], off)
                continue
            w_sq = max(float((w * w).sum()), 1e-300)
            readings['scaled'] = worst(readings['scaled'], float(
                (g - w).abs().max() / max(float(w.abs().max()), 1e-300)))
            readings['rel'] = worst(readings['rel'], math.sqrt(
                float(((g - w) ** 2).sum()) / w_sq))
            readings['scale'] = worst(readings['scale'], abs(
                float((g * w).sum()) / w_sq - 1.0))
        out[moment] = readings
    return out


def mesh_knob_checks(mesh, vocabs, device, root: Path) -> dict:
    """The training knobs on this rank of the (2, 2) mesh, java14m width
    and vocabulary (module docstring, phase 17): SHARD_CONTEXTS on the
    plane wire against the unsharded mesh route (code and gradients, one
    global batch and keep mask; the encode kernel on a context slice's
    rows; a step at C = 1024 with and without the knob, peak bytes;
    ``mesh_rank`` evaluates with it); 'zero' against 'mirror' over MESH_ZERO_STEPS steps
    from one state (digests, moment bytes, peak bytes); a lazy-Adam step
    against the one-rank lazy step on the same global batch; the fp32
    routes and the gather kernel's fp32 stream against their plain
    versions and the one-rank route, then two fp32 ``train()`` steps. Each
    path's launches are counted from zero just before it."""
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.models import functional
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.models.functional import Code2VecParams
    from code2vec_tpu_torch.ops import encode as encode_ops
    from code2vec_tpu_torch.ops import lazy_adam, ragged
    from code2vec_tpu_torch.parallel.mesh import TABLES
    from code2vec_tpu_torch.training.trainer import Trainer, packed_rows
    on_card = device.type == 'cuda'
    shape = dict(MESH_DATA_AXIS_SIZE=MESH_SHAPE[0],
                 MESH_MODEL_AXIS_SIZE=MESH_SHAPE[1])
    prefix = str(root / 'java14m')

    def config_of(**knobs):
        return Config(**dict(dict(TRAIN_DATA_PATH_PREFIX=prefix,
                                  USE_PALLAS_FUSED_CE=True, **shape),
                             **knobs))

    def peak_reset() -> int:
        if not on_card:
            return 0
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)

    def peak() -> int:
        if not on_card:
            return 0
        torch.cuda.synchronize(device)
        return torch.cuda.max_memory_allocated(device)

    out = {}
    d, m = mesh.data_index, mesh.model_index
    per = 1024 // mesh.data
    rows = slice(d * per, (d + 1) * per)
    bf16 = torch.bfloat16
    cat = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    full = TorchBackend(config_of(), vocabs, device, seed=1)
    start = Code2VecParams(*[t.clone() for t in full.params])
    tpad, ppad = full.token_pad_index, full.path_pad_index
    context_dim, code_dim = full.transform.shape
    token_dim = full.token_embedding.shape[1]
    ranges = {name: slice(*mesh.row_range(getattr(start, name).shape[0]))
              for name in TABLES}
    local_start = [getattr(start, name)[ranges[name]] if name in TABLES
                   else getattr(start, name)
                   for name in Code2VecParams._fields]
    del full

    # ---- SHARD_CONTEXTS: the dense encode against the unsharded route
    local = TorchBackend(config_of(), vocabs, device, params=start,
                         mesh=mesh)
    rng = np.random.default_rng(31)
    plane = plane_batch(rng, 1024, 200, vocabs.token_vocab.size,
                        vocabs.path_vocab.size, tpad, ppad)
    planes = [cat(a[rows]) for a in (plane.source, plane.path,
                                     plane.target, plane.mask)]
    gen = torch.Generator(device=device)
    gen.manual_seed(40 + d)          # one keep mask a data row
    keep = torch.rand((per, 200, context_dim), generator=gen,
                      device=device) < 0.75
    cot = torch.randn((per, code_dim), generator=gen, device=device)

    def encode_grads(shard):
        p = [t.detach().clone().requires_grad_() for t in (
            local.token_embedding, local.path_embedding, local.transform,
            local.attention)]
        params = Code2VecParams(p[0], p[1], local.target_embedding.detach(),
                                p[2], p[3])
        code, _ = functional.encode(params, *planes, dtype=bf16,
                                    keep_mask=keep, keep_rate=0.75,
                                    mesh=mesh, shard_contexts=shard)
        (code * cot).sum().backward()
        return code.detach(), [t.grad for t in p]

    code_u, grads_u = encode_grads(False)
    code_s, grads_s = encode_grads(True)
    out['shard_code_err'] = scaled_err([code_s], [code_u])
    out['shard_grad_err'] = scaled_err(grads_s, grads_u)
    check(all(bool(torch.isfinite(t).all()) for t in [code_s] + grads_s),
          'SHARD_CONTEXTS gave a non-finite code vector or gradient')
    # the encode kernel on this rank's context slice against its plain
    # version, timed beside the cuBLAS route
    comp = local.compute_params
    contexts = mesh.context_slice(200)
    n_rows = per * (contexts.stop - contexts.start)
    take = lambda table, idx: torch.nn.functional.embedding(  # noqa
        idx[:, contexts].reshape(-1).long(), table)
    with torch.no_grad():
        full_tables = mesh.gather_params(
            {'token_embedding': comp.token_embedding,
             'path_embedding': comp.path_embedding})
        enc_in = (take(full_tables['token_embedding'], planes[0]),
                  take(full_tables['path_embedding'], planes[1]),
                  take(full_tables['token_embedding'], planes[2]),
                  comp.transform, comp.attention)
        del full_tables
        x_k, s_k = encode_ops.fused_context_transform(*enc_in)
        x_p, s_p = encode_ops._transform_plain(*enc_in)
    slice_rec = {'err': scaled_err([x_k, s_k], [x_p, s_p]), 'rows': n_rows}
    if on_card:
        slice_rec['ms'] = cuda_ms(
            lambda: encode_ops.fused_context_transform(*enc_in))
        slice_rec['plain_ms'] = cuda_ms(
            lambda: encode_ops._transform_plain(*enc_in))
        slice_rec['library_ms'] = cuda_ms(
            lambda: library_encode(*enc_in))
    else:
        slice_rec.update(ms=0.0, plain_ms=0.0, library_ms=0.0)
    slice_rec['bound'] = bound(
        n_rows * (context_dim * 2 + code_dim * 4 + 4)
        + context_dim * code_dim * 2, 2.0 * n_rows * context_dim * code_dim,
        'bfloat16')
    out['slice_encode'] = slice_rec
    del code_u, code_s, grads_u, grads_s, keep, cot, enc_in, x_k, x_p, comp
    del local
    # ---- SHARD_CONTEXTS: a step at C = 1024, peak bytes with and without
    long_rng = np.random.default_rng(32)
    long = plane_batch(long_rng, 1024, MESH_LONG_CONTEXTS,
                       vocabs.token_vocab.size, vocabs.path_vocab.size, tpad,
                       ppad, counts=long_rng.integers(
                           1, MESH_LONG_CONTEXTS + 1, 1024))
    long = long._replace(label=long_rng.integers(
        1, vocabs.target_vocab.size, 1024).astype(np.int32))
    long_local = tuple(cat(a[rows]) for a in long.device_arrays())
    out['long'] = {}
    for shard in (False, True):
        config = config_of(BATCH_WIRE_FORMAT='planes', SHARD_CONTEXTS=shard,
                           MAX_CONTEXTS=MESH_LONG_CONTEXTS)
        backend = TorchBackend(config, vocabs, device, params=start,
                               mesh=mesh)
        trainer = Trainer(config, backend, mesh=mesh)
        state = trainer.state_from_params()
        base = peak_reset()
        state, loss = trainer.train_step_placed(state, long_local)
        out['long'][str(shard)] = {'loss': float(loss), 'peak': peak(),
                                   'base': base}
        del backend, trainer, state
    del long_local

    # ---- 'zero' against 'mirror': MESH_ZERO_STEPS steps from one state
    def local_packed(packed):
        return (cat(packed.ctx)[d:d + 1].contiguous(),
                cat(packed.count)[rows].contiguous(),
                cat(packed.label)[rows].contiguous(),
                cat(packed.weight)[rows].contiguous())

    batches = [local_packed(mesh_global_batch(vocabs, 50 + i))
               for i in range(MESH_ZERO_STEPS)]
    out['zero'] = {}
    for layout in ('mirror', 'zero'):
        # 'dedup': on the card torch's index_add_ of the table gradients
        # adds duplicate rows by atomics, in no fixed order, so two runs of
        # one layout differ in the last bits; dedup writes each row once
        config = config_of(OPTIMIZER_STATE_SHARDING=layout,
                           EMBED_GRAD_IMPL='dedup')
        backend = TorchBackend(config, vocabs, device, params=start,
                               mesh=mesh)
        trainer = Trainer(config, backend, mesh=mesh)
        base = peak_reset()
        state = trainer.state_from_params()
        moments = state.opt_state.mu + state.opt_state.nu
        moment_bytes = sum(t.numel() * t.element_size() for t in moments)
        zero_mesh_counts()
        losses = []
        for arrays in batches:
            state, loss = trainer.train_step(state, arrays)
            losses.append(float(loss))
        counts = mesh_launch_counts()
        named = trainer.named_opt_state(state.opt_state)
        fields = Code2VecParams._fields
        out['zero'][layout] = {
            'params_sha': tensor_sha(state.params),
            'moments_sha': tensor_sha([named['mu'][n] for n in fields]
                                      + [named['nu'][n] for n in fields]),
            'dense_sha': tensor_sha([state.params.transform,
                                     state.params.attention]),
            'moment_bytes': moment_bytes, 'peak': peak(), 'base': base,
            'losses': losses, 'counts': counts}
        del backend, trainer, state, named, moments
    del batches

    # ---- lazy Adam: MESH_LAZY_STEPS steps against the one-rank lazy steps
    # on the same global batches (keep 1.0: the one rank draws one dropout
    # mask for a global batch, each data rank its own)
    config = config_of(LAZY_EMBEDDING_ADAM=True, DROPOUT_KEEP_RATE=1.0)
    lazy_batches = [mesh_global_batch(vocabs, 60 + i)
                    for i in range(MESH_LAZY_STEPS)]
    one = TorchBackend(config, vocabs, device, params=start)
    one_trainer = Trainer(config, one)
    one_state = one_trainer.state_from_params()
    for packed in lazy_batches:
        one_state, one_loss = one_trainer.train_step(
            one_state, tuple(cat(a) for a in (packed.ctx, packed.count,
                                              packed.label, packed.weight)))

    def lazy_tensors(params, opt_state, slicing):
        named = lazy_adam.named_state(opt_state)
        fields = Code2VecParams._fields
        cut = (lambda name, t: t[ranges[name]] if name in TABLES else t) \
            if slicing else (lambda name, t: t)
        moments = {k: [cut(n, named['dense'][k][n])
                       for n in lazy_adam.LazyEmbeddingAdam.DENSE_KEYS]
                   + [cut(n, named[k][n])
                      for n in lazy_adam.LazyEmbeddingAdam.SPARSE_KEYS]
                   for k in ('mu', 'nu')}
        return dict(params=[cut(n, t) for n, t in zip(fields, params)],
                    **moments)

    want = lazy_tensors(one_state.params, one_state.opt_state, True)
    backend = TorchBackend(config, vocabs, device, params=start, mesh=mesh)
    trainer = Trainer(config, backend, mesh=mesh)
    state = trainer.state_from_params()
    zero_mesh_counts()
    for packed in lazy_batches:
        state, loss = trainer.train_step(state, local_packed(packed))
    lazy_counts = mesh_launch_counts()
    got = lazy_tensors(state.params, state.opt_state, False)
    readings = slice_readings(got, want, local_start)
    # rows no rank touched in any step: bit for bit as they were, moments
    # zero
    touched_rows = [packed_rows(cat(p.ctx), tpad, ppad)
                    for p in lazy_batches]
    source = torch.cat([t[0] for t in touched_rows])
    path = torch.cat([t[1] for t in touched_rows])
    target = torch.cat([t[2] for t in touched_rows])
    untouched = {}
    for name, idx in (('token_embedding', torch.cat([source, target])),
                      ('path_embedding', path)):
        table = getattr(state.params, name)
        lo = ranges[name].start
        mask = torch.ones(table.shape[0] + 1, dtype=torch.bool,
                          device=device)
        local_idx = idx.long() - lo
        mask[torch.where((local_idx >= 0) & (local_idx < table.shape[0]),
                         local_idx, table.shape[0])] = False
        mask = mask[:table.shape[0]]
        still = bit_mismatches(table.detach()[mask],
                               getattr(start, name)[ranges[name]][mask])
        untouched[name] = {
            'rows': int(mask.sum()), 'moved': still,
            'moments': int((state.opt_state.mu[name][mask] != 0).sum()
                           + (state.opt_state.nu[name][mask] != 0).sum())}
    out['lazy'] = {'readings': readings, 'counts': lazy_counts,
                   'loss': float(loss), 'one_loss': float(one_loss),
                   'untouched': untouched}
    # the row kernel on this rank's token slice over the mesh's row mask
    table_rows = state.params.token_embedding.shape[0]
    row_mask = lazy_adam.mesh_touched_rows(torch.cat([source, target]),
                                           table_rows, mesh)
    compact = torch.nonzero(row_mask).reshape(-1)
    gen.manual_seed(12)
    tshape = state.params.token_embedding.shape
    kw = dict(generator=gen, device=device)
    rows_start = [torch.randn(tshape, **kw), torch.randn(tshape, **kw) * 1e-3,
                  torch.rand(tshape, **kw) * 1e-5]
    grad = torch.randn(tshape, **kw) * 1e-2
    rows_got = [t.clone() for t in rows_start]
    rows_want = [t.clone() for t in rows_start]
    zero_counts()
    lazy_adam.sparse_row_adam(*rows_got, grad, row_mask, learning_rate=1e-3,
                              step=3)
    lazy_adam.sparse_row_adam_plain(*rows_want, grad, compact,
                                    lazy_adam.lazy_rate(1e-3, 3))
    rows_rec = {'err': max_err(rows_got, rows_want),
                'rows': int(compact.numel()), 'listed': int(row_mask.numel())}
    if on_card:
        rows_rec['mismatches'] = sum(bit_mismatches(g, w)
                                     for g, w in zip(rows_got, rows_want))
        rows_rec['ms'] = cuda_ms(lambda: lazy_adam.sparse_row_adam(
            *rows_got, grad, row_mask, learning_rate=1e-3, step=3))
        rows_rec['plain_ms'] = cuda_ms(lambda: lazy_adam.sparse_row_adam_plain(
            *rows_want, grad, compact, lazy_adam.lazy_rate(1e-3, 3)))
        rows_rec['library_ms'] = library_sparse_adam(rows_start[0], grad,
                                                     compact, 1e-3)
    else:
        rows_rec.update(mismatches=0, ms=0.0, plain_ms=0.0, library_ms=0.0)
    rows_rec['bound'] = bound(compact.numel() * tshape[1] * 28
                              + row_mask.numel(), 0.0, 'float32')
    out['mesh_rows'] = rows_rec
    del one, one_trainer, one_state, backend, trainer, state, got, want
    del rows_got, rows_want, rows_start, grad

    # ---- fp32: the routes, the gather kernel's fp32 stream
    f32 = torch.float32
    config = config_of(COMPUTE_DTYPE='float32')
    full32 = TorchBackend(config, vocabs, device, params=start)
    local32 = TorchBackend(config, vocabs, device, params=start, mesh=mesh)
    packed = mesh_global_batch(vocabs, 20)
    g_ctx, g_count = cat(packed.ctx), cat(packed.count)
    l_ctx, l_count = g_ctx[d:d + 1].contiguous(), g_count[rows].contiguous()
    gen.manual_seed(21)
    keep = torch.rand(g_ctx.shape[:2] + (context_dim,), generator=gen,
                      device=device) < 0.75
    g_cot = torch.randn((1024, code_dim), generator=gen, device=device)
    kw32 = dict(token_pad=tpad, path_pad=ppad, dtype=f32, keep_rate=0.75)

    def encode32(backend, ctx, count, mask, msh, cot_):
        params = [p.detach().clone().requires_grad_()
                  for p in (backend.token_embedding, backend.path_embedding,
                            backend.transform, backend.attention)]
        code = ragged.ragged_encode_code(*params, ctx, count,
                                         keep_mask=mask, mesh=msh, **kw32)
        (code * cot_).sum().backward()
        return code.detach(), [p.grad for p in params]

    one_code, one_grads = encode32(full32, g_ctx, g_count, keep, None, g_cot)
    zero_mesh_counts()
    mesh_code, mesh_grads = encode32(local32, l_ctx, l_count, keep[d:d + 1],
                                     mesh, g_cot[rows])
    route_counts = mesh_launch_counts()
    out['fp32_code_err'] = scaled_err([mesh_code], [one_code[rows]])
    out['fp32_grad_err'] = scaled_err(
        mesh_grads, [one_grads[0][ranges['token_embedding']],
                     one_grads[1][ranges['path_embedding']], one_grads[2],
                     one_grads[3]])
    del one_grads, mesh_grads, full32
    segs = ragged._segment_inputs(l_ctx, l_count, tpad, ppad)
    gather_args = (local32.token_embedding.detach(),
                   local32.path_embedding.detach(), segs, f32, keep[d:d + 1],
                   0.75, ranges['token_embedding'].start,
                   ranges['path_embedding'].start)
    e_kernel = ragged._gather_range_kernel(*gather_args)
    e_plain = ragged._gather_range_plain(*gather_args)
    # a copy and the keep mask: the kernel divides by the keep rate, torch
    # on the card multiplies by its reciprocal, one fp32 rounding apart
    out['fp32_gather_err'] = scaled_err([e_kernel], [e_plain])
    out['fp32_gather_unequal'] = int((e_kernel != e_plain).sum())
    check(e_kernel.dtype == f32
          and out['fp32_gather_err'] <= MESH_FP32_GATHER_LIMIT,
          'the gather kernel\'s fp32 stream differs from its plain version '
          '(%.3g of the scale)' % out['fp32_gather_err'])
    del e_kernel, e_plain, segs
    comp32 = local32.compute_params
    mask_l = keep[d:d + 1]

    def stats_route():
        return ragged.ragged_encode(
            comp32.token_embedding, comp32.path_embedding, comp32.transform,
            comp32.attention, l_ctx, l_count, max_contexts=200,
            token_pad=tpad, path_pad=ppad, dtype=f32, mesh=mesh)

    def grads_route():
        return encode32(local32, l_ctx, l_count, mask_l, mesh, g_cot[rows])

    fp32 = {'ms': {'fp32_stats': timed_ms(stats_route),
                   'fp32_grads': timed_ms(grads_route, reps=2)}}
    with PlainRoutes():
        fp32['plain_ms'] = {'fp32_stats': timed_ms(stats_route, reps=2),
                            'fp32_grads': timed_ms(grads_route, reps=1)}
    with torch.no_grad():
        got_stats = list(stats_route())
    got_grads = grads_route()[1]
    with PlainRoutes():
        with torch.no_grad():
            want_stats = list(stats_route())
        want_grads = grads_route()[1]
    fp32['plain_err'] = {'fp32_stats': scaled_err(got_stats, want_stats),
                         'fp32_grads': scaled_err(got_grads, want_grads)}
    check(all(bool(torch.isfinite(t).all()) for t in got_stats + got_grads),
          'an fp32 mesh route gave a non-finite output')
    n = int(l_count.sum())
    stream = n * context_dim * 4
    fp32['bound'] = {
        'fp32_stats': bound(n * 3 * 4 + n * 3 * token_dim * 4 / mesh.model
                            + 2 * stream + context_dim * code_dim * 4
                            + per * (code_dim + 2) * 4,
                            2.0 * n * context_dim * code_dim, 'float32'),
        'fp32_grads': bound(stream + n * context_dim * 4
                            + 2 * n * code_dim * 4
                            + context_dim * code_dim * 4,
                            6.0 * n * context_dim * code_dim, 'float32')}
    fp32['route_counts'] = route_counts
    out['fp32'] = fp32
    del local32, comp32, keep, g_cot, got_grads, want_grads, got_stats
    del want_stats, one_code, mesh_code
    # two fp32 train() steps on the mesh
    fp32_model = Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(root / 'fp32'), USE_PALLAS_FUSED_CE=True,
        COMPUTE_DTYPE='float32', NUM_TRAIN_EPOCHS=1, **shape),
        device=device, params=start, mesh=mesh)
    zero_mesh_counts()
    losses = fp32_model.train()
    out['fp32_train'] = {'counts': mesh_launch_counts(),
                         'steps': int(fp32_model.state.step),
                         'losses': losses}
    del fp32_model, start, local_start
    if on_card:
        torch.cuda.empty_cache()
    return out


MESH_SERVE_LINES = 2500          # kept lines of the bulk export across ranks
MESH_SERVE_EMPTY = 20            # lines without a valid context among them
MESH_SERVE_PREDICT = 200         # predict's lines, on every rank
MESH_SERVE_ROWS = 1 << 20        # the sharded exact index's f16 rows
MESH_SERVE_QUERIES = 512
MESH_SERVE_K = 10


def write_serve_inputs(root: Path, sizes, gpu: str) -> None:
    """The inputs of the ranks' serving checks (``mesh_serve_checks``): a
    corpus of MESH_SERVE_LINES kept lines and MESH_SERVE_EMPTY without a
    valid context (a short final batch of 1024 whose second data shard is
    padding only), predict's lines, a cosine f16 store of MESH_SERVE_ROWS
    clustered rows and its queries."""
    from code2vec_tpu_torch.index import store as store_lib
    rng = np.random.default_rng(44)
    lines = make_lines(rng, MESH_SERVE_LINES, sizes, 200)
    for i in range(MESH_SERVE_EMPTY):
        lines.insert(i * (MESH_SERVE_LINES // MESH_SERVE_EMPTY),
                     'empty|line%d %s' % (i, ' ' * 199))
    (root / 'serve.c2v').write_text('\n'.join(lines) + '\n')
    (root / 'serve_predict.c2v').write_text('\n'.join(make_lines(
        rng, MESH_SERVE_PREDICT, sizes, 200)) + '\n')
    t0 = time.perf_counter()
    rows = index_rows(MESH_SERVE_ROWS, 45)
    store_lib.build(str(root / 'serve.vecindex'), [rows], dtype='float16',
                    metric='cosine')
    np.save(root / 'serve_queries.npy',
            near_queries(rows, MESH_SERVE_QUERIES, 46))
    print('mesh serve: a %d-line corpus (%d without a valid context), %d '
          'predict lines, a %d x %d f16 cosine store (%.2f GB) and %d '
          'queries written in %.1f s [%s]'
          % (len(lines), MESH_SERVE_EMPTY, MESH_SERVE_PREDICT,
             MESH_SERVE_ROWS, INDEX_DIM, MESH_SERVE_ROWS * INDEX_DIM * 2 / 1e9,
             MESH_SERVE_QUERIES, time.perf_counter() - t0, gpu))


def mesh_serve_checks(model, root: Path, device, knob) -> dict:
    """One rank's serving paths on the trained mesh model (every rank
    runs them together, the chief writing the outputs): the bulk export
    on the packed wire (the ragged forward and the gather kernel once a
    batch on every rank), ``predict`` on the plane wire through the
    encode kernel, and the exact index sharded over the data axis: its
    resident bytes, its search of the queries."""
    import torch
    from code2vec_tpu_torch.index import store as store_lib
    from code2vec_tpu_torch.index.exact import ExactIndex
    from code2vec_tpu_torch.serving import bulk
    on_card = device.type == 'cuda'
    out = {}
    knob('SHARD_CONTEXTS', False)
    knob('BATCH_WIRE_FORMAT', 'packed')
    knob('USE_PALLAS_FUSED_ENCODE', False)
    zero_mesh_counts()
    t0 = time.perf_counter()
    n, _path = bulk.export_code_vectors(model, str(root / 'serve.c2v'),
                                        str(root / 'serve.vectors'))
    out['export_s'] = time.perf_counter() - t0
    out['export_rows'] = n
    out['export_counts'] = mesh_launch_counts()
    knob('BATCH_WIRE_FORMAT', 'planes')
    knob('USE_PALLAS_FUSED_ENCODE', True)
    lines = (root / 'serve_predict.c2v').read_text().splitlines()
    zero_mesh_counts()
    t0 = time.perf_counter()
    results = model.predict(lines, tier='topk')
    out['predict_s'] = time.perf_counter() - t0
    out['predict_counts'] = mesh_launch_counts()
    out['predict'] = [[list(r.topk_predicted_words),
                       [float(x) for x in r.topk_predicted_words_scores]]
                      for r in results]
    knob('BATCH_WIRE_FORMAT', 'packed')
    knob('USE_PALLAS_FUSED_ENCODE', False)
    store = store_lib.VectorStore(str(root / 'serve.vecindex'))
    queries = np.load(root / 'serve_queries.npy')
    if on_card:
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
    index = ExactIndex(store, mesh=model.mesh, device=device)
    out['index_allocated'] = ((torch.cuda.memory_allocated(device) - before)
                              if on_card else 0)
    out['index_nbytes'] = index.device_nbytes
    out['index_shard'] = (index.row_offset, index.shard_rows,
                          index.padded_rows)
    index.search(queries, MESH_SERVE_K)        # the blocks' allocations
    t0 = time.perf_counter()
    values, ids = index.search(queries, MESH_SERVE_K)
    out['search_s'] = time.perf_counter() - t0
    if model.is_chief:
        np.save(root / 'serve_ids.npy', ids)
        np.save(root / 'serve_values.npy', values)
    del index
    return out


def serve_comparisons(ranks, one, root: Path, gpu: str) -> dict:
    """The parent's side of ``mesh_serve_checks``: each rank's launches,
    then the one-rank model restored from the mesh's checkpoint on this
    card against the chief's outputs: the export in corpus order, predict's
    top-1 agreement, the index's ids. Returns the launches, summed over
    the ranks."""
    from code2vec_tpu_torch.index import store as store_lib
    from code2vec_tpu_torch.index.exact import ExactIndex
    from code2vec_tpu_torch.serving import bulk
    batches = -(-MESH_SERVE_LINES // 1024)
    for out in ranks:
        serve, r = out['serve'], out['rank']
        check(serve['export_rows'] == MESH_SERVE_LINES
              and serve['export_counts']['ragged_fwd'] == batches
              and serve['export_counts']['gather'] == batches
              and serve['predict_counts']['encode'] == 1,
              'rank %d: the bulk export wrote %d rows with launches %s, '
              'predict launched %s' % (r, serve['export_rows'],
                                       serve['export_counts'],
                                       serve['predict_counts']))
        lo, shard, padded = serve['index_shard']
        print('mesh serve rank %d %s: bulk export %d rows in %.2f s (%d '
              'batches: ragged_fwd %d, gather %d launches); predict %d lines '
              'on the plane wire in %.2f s (encode %d); exact index rows '
              '[%d, %d) of %d padded, %d bytes resident (%.3f GB allocated '
              'on the card), a search of %d queries %.3f s [%s]'
              % (r, tuple(out['coords']), serve['export_rows'],
                 serve['export_s'], batches,
                 serve['export_counts']['ragged_fwd'],
                 serve['export_counts']['gather'], MESH_SERVE_PREDICT,
                 serve['predict_s'], serve['predict_counts']['encode'], lo,
                 lo + shard, padded, serve['index_nbytes'],
                 serve['index_allocated'] / 1e9, MESH_SERVE_QUERIES,
                 serve['search_s'], gpu))
    # the export, in corpus order, against one rank's
    t0 = time.perf_counter()
    bulk.export_code_vectors(one, str(root / 'serve.c2v'),
                             str(root / 'serve_one.vectors'))
    got = np.loadtxt(root / 'serve.vectors', dtype=np.float32)
    want = np.loadtxt(root / 'serve_one.vectors', dtype=np.float32)
    check(got.shape == want.shape == (MESH_SERVE_LINES, INDEX_DIM),
          'the mesh export holds %r rows, one rank\'s %r'
          % (got.shape, want.shape))
    export_err = float(np.abs(got - want).max()
                       / max(float(np.abs(want).max()), 1e-30))
    check(export_err <= MESH_CODE_LIMIT,
          'the mesh export against one rank\'s: %.3g of scale' % export_err)
    # predict through the encode kernel on one rank
    for config in (one.config, one.backend.config, one.trainer.config):
        config.BATCH_WIRE_FORMAT = 'planes'
        config.USE_PALLAS_FUSED_ENCODE = True
    lines = (root / 'serve_predict.c2v').read_text().splitlines()
    want_predict = one.predict(lines, tier='topk')
    chief = ranks[0]['serve']['predict']
    for out in ranks[1:]:
        check(out['serve']['predict'] == chief,
              'rank %d\'s predict differs from the chief\'s' % out['rank'])
    top1 = np.mean([g[0][0] == w.topk_predicted_words[0]
                    for g, w in zip(chief, want_predict)])
    score_err = max(float(np.abs(np.asarray(g[1]) - np.asarray(
        w.topk_predicted_words_scores)).max())
        for g, w in zip(chief, want_predict)
        if g[0] == w.topk_predicted_words) if top1 else float('nan')
    check(top1 >= MESH_TOP1_LIMIT, 'the mesh predict\'s top-1 agreement with '
          'one rank %.4f under %.2f' % (top1, MESH_TOP1_LIMIT))
    # the sharded index's ids against one rank's
    queries = np.load(root / 'serve_queries.npy')
    index = ExactIndex(store_lib.VectorStore(str(root / 'serve.vecindex')),
                       device=DEVICE)
    want_v, want_i = index.search(queries, MESH_SERVE_K)
    del index
    got_i = np.load(root / 'serve_ids.npy')
    got_v = np.load(root / 'serve_values.npy')
    check(np.array_equal(got_i, want_i),
          'the sharded exact index\'s ids differ from one rank\'s in %d of '
          '%d' % (int((got_i != want_i).sum()), got_i.size))
    print('mesh serve: against one rank on this card: the export %d rows in '
          'corpus order, %.3g of scale apart (limit %g); predict top-1 '
          'agreement %.4f, score |diff| %.3g where the words agree; the '
          'sharded index\'s %d x %d ids equal, scores |diff| %.3g; %.1f s '
          '[%s]' % (got.shape[0], export_err, MESH_CODE_LIMIT, top1,
                    score_err, MESH_SERVE_QUERIES, MESH_SERVE_K,
                    float(np.abs(got_v - want_v).max()),
                    time.perf_counter() - t0, gpu))
    return {name: sum(out['serve'][key][name] for out in ranks)
            for key, name in (('export_counts', 'ragged_fwd'),
                              ('export_counts', 'gather'),
                              ('predict_counts', 'encode'))}


def mesh_rank(rank: int, world: int, device, root: Path) -> dict:
    """One rank of the mesh phase (module docstring): the route checks,
    then ``Code2VecModel.train()`` and ``evaluate()`` on the mesh, with
    this rank's launches, step interval and peak memory, and the gathered
    state's digests for the parent's restore."""
    import torch
    from code2vec_tpu_torch.checkpoints import map_opt_state
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.models.backends import table_sizes
    from code2vec_tpu_torch.ops import lazy_adam
    from code2vec_tpu_torch.parallel.mesh import create_mesh
    from code2vec_tpu_torch.vocab import Code2VecVocabs
    prefix = root / 'java14m'
    shape = dict(MESH_DATA_AXIS_SIZE=MESH_SHAPE[0],
                 MESH_MODEL_AXIS_SIZE=MESH_SHAPE[1])
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    USE_PALLAS_FUSED_CE=True, **shape)
    mesh = create_mesh(config)
    vocabs = Code2VecVocabs(config)
    # the target rows of one rank's allocation, where the digests stop
    one_rows = table_sizes(Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                  USE_PALLAS_FUSED_CE=True),
                           vocabs)['target_vocab_size']
    t0 = time.perf_counter()
    out = {'rank': rank, 'coords': (mesh.data_index, mesh.model_index)}
    out['routes'] = mesh_route_checks(mesh, vocabs, config, device)
    out['routes_s'] = time.perf_counter() - t0
    print('mesh rank %d routes: %s' % (rank, json.dumps(out['routes'])),
          flush=True)
    t0 = time.perf_counter()
    out['knobs'] = mesh_knob_checks(mesh, vocabs, device, root)
    out['knobs_s'] = time.perf_counter() - t0
    print('mesh rank %d knobs: %s' % (rank, json.dumps(out['knobs'])),
          flush=True)
    del vocabs
    on_card = device.type == 'cuda'
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    # the main path: train() on the mesh from seed 1 with telemetry on,
    # saving its last epoch, then evaluate()
    train_config = Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), USE_PALLAS_FUSED_CE=True,
        NUM_TRAIN_EPOCHS=MESH_TRAIN_EPOCHS,
        SAVE_EVERY_EPOCHS=MESH_TRAIN_EPOCHS,
        MODEL_SAVE_PATH=str(root / 'checkpoint' / 'saved'),
        NUM_BATCHES_TO_LOG_PROGRESS=4, TELEMETRY=True,
        TELEMETRY_DIR=str(root / 'telemetry'), **shape)
    model = Code2VecModel(train_config, device=device, seed=1)
    check(model.mesh is not None and model.mesh.size == world,
          'the model is not on the %d-rank mesh' % world)
    timings = []
    zero_mesh_counts()
    t0 = time.perf_counter()
    losses = model.train(timings=timings)
    out['train_s'] = time.perf_counter() - t0
    out['train_counts'] = mesh_launch_counts()
    out['steps'] = int(model.state.step)
    out['losses'] = losses
    out['interval_ms'] = [statistics.median(t['interval_ms'])
                          for t in timings if t['interval_ms']]
    out['peak_bytes'] = (torch.cuda.max_memory_allocated(device)
                         if on_card else 0)
    from code2vec_tpu_torch.telemetry import core as tele_core
    mfu = tele_core.registry().snapshot().get('train/mfu')
    out['mfu'] = None if mfu is None else float(mfu)
    suffix = '' if rank == 0 else '.proc%d' % rank
    out['telemetry_files'] = [
        name % suffix for name in ('metrics%s.jsonl', 'metrics%s.prom',
                                   'intervals%s.jsonl')
        if (root / 'telemetry' / (name % suffix)).is_file()]
    params = model.backend.params
    out['dense_sha'] = tensor_sha([params.transform, params.attention])
    gathered = model.backend.gathered_params()._asdict()
    moments = map_opt_state(lazy_adam.named_state(model.state.opt_state),
                            model.mesh.gather_params)
    out['params_sha'], out['moments_sha'] = state_digests(gathered, moments,
                                                          one_rows)
    del gathered, moments
    eval_config = Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), USE_PALLAS_FUSED_CE=True,
        TEST_DATA_PATH=str(prefix) + '.test.c2v', **shape)
    model.config = eval_config
    zero_mesh_counts()
    old = os.getcwd()
    os.chdir(root)
    try:
        results = model.evaluate()
    finally:
        os.chdir(old)
    out['eval_counts'] = mesh_launch_counts()
    out['eval'] = {'top1': float(results.topk_acc[0]),
                   'f1': float(results.subtoken_f1),
                   'loss': results.loss}
    # the same trained model on the plane wire through the encode kernel,
    # without SHARD_CONTEXTS and with it (the encode kernel on the rank's
    # context slice): the encode kernel once a batch on each rank. The
    # backend and the trainer hold the training config.
    def knob(name, value):
        for config in (model.config, model.backend.config,
                       model.trainer.config):
            setattr(config, name, value)

    knob('BATCH_WIRE_FORMAT', 'planes')
    knob('USE_PALLAS_FUSED_ENCODE', True)
    shard_eval = {}
    os.chdir(root)
    try:
        for shard in (False, True):
            knob('SHARD_CONTEXTS', shard)
            zero_mesh_counts()
            results = model.evaluate()
            shard_eval[str(shard)] = {
                'counts': mesh_launch_counts(), 'loss': results.loss,
                'top1': float(results.topk_acc[0])}
    finally:
        os.chdir(old)
    out['knobs']['shard_eval'] = shard_eval
    # the serving paths across the ranks: the bulk export, predict, the
    # sharded exact index
    out['serve'] = mesh_serve_checks(model, root, device, knob)
    return out


def mesh_rank_main(argv) -> int:
    """``chip_smoke.py mesh-train-rank RANK WORLD BACKEND DIR DEVICE``: one
    rank of the mesh phase, joined over a file store in DIR, on DEVICE's
    type ('cuda'; 'cpu' rehearses on the plain versions); its result
    written to DIR/rank<r>.json."""
    import torch
    import torch.distributed as dist
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import _build
    from code2vec_tpu_torch.parallel import distributed
    global DEVICE
    rank, world, backend, root, DEVICE = (int(argv[0]), int(argv[1]),
                                          argv[2], Path(argv[3]), argv[4])
    distributed.maybe_initialize_distributed(
        world_size=world, rank=rank,
        local_rank=rank if backend == 'nccl' else 0, backend=backend,
        store=dist.FileStore(str(root / 'store'), world), timeout_s=300,
        log=lambda s: print('mesh rank %d: %s' % (rank, s), flush=True))
    device = distributed.local_device(DEVICE)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
        device_lib.disable_tf32()
        for name in _build.SOURCES:
            _build.load(name)
    out = mesh_rank(rank, world, device, root)
    (root / ('rank%d.json' % rank)).write_text(json.dumps(out))
    distributed.shutdown()
    return 0


def mesh_train_phase(gpu: str) -> dict:
    """The training and evaluation main path over a (2, 2) mesh of ranks:
    four rank processes (``mesh_rank_main``), over nccl with one card each
    when the host has four, else over gloo on this card; the checks named
    in the module docstring; then a one-rank model on the card restores
    the mesh's checkpoint. Returns the JSON records of the B7 routes and
    the ranks' summed launches."""
    import subprocess
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.ops import lazy_adam
    from code2vec_tpu_torch.vocab import Code2VecVocabs
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    cards = torch.cuda.device_count()
    backend = 'nccl' if cards >= world else 'gloo'
    print('mesh train: %d ranks on a %dx%d mesh over %s (%d card(s)%s)'
          % (world, MESH_SHAPE[0], MESH_SHAPE[1], backend, cards,
             '' if backend == 'nccl' else ', every rank on card 0; its '
             'collectives are host copies, so their times claim nothing'))
    root = SMOKE_DIR / 'mesh_train'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    prefix = root / 'java14m'
    shutil.copy(str(SMOKE_DIR / 'java14m.dict.c2v'),
                str(prefix) + '.dict.c2v')
    vocabs = Code2VecVocabs(Config(TRAIN_DATA_PATH_PREFIX=str(prefix)))
    sizes = tuple(v.size - 1 for v in (
        vocabs.token_vocab, vocabs.path_vocab, vocabs.target_vocab))
    del vocabs
    rng = np.random.default_rng(22)
    for suffix, n in (('.train.c2v', MESH_TRAIN_LINES),
                      ('.test.c2v', MESH_EVAL_LINES)):
        Path(str(prefix) + suffix).write_text(
            '\n'.join(make_lines(rng, n, sizes, 200)) + '\n')
    # the fp32 train() split
    shutil.copy(str(SMOKE_DIR / 'java14m.dict.c2v'),
                str(root / 'fp32.dict.c2v'))
    (root / 'fp32.train.c2v').write_text(
        '\n'.join(make_lines(rng, MESH_FP32_LINES, sizes, 200)) + '\n')
    write_serve_inputs(root, sizes, gpu)
    print('mesh train: java14m width and vocabulary (%d/%d/%d), bf16, fused '
          'CE, keep 0.75; cut: %d train lines x %d epochs, %d eval lines'
          % (sizes + (MESH_TRAIN_LINES, MESH_TRAIN_EPOCHS, MESH_EVAL_LINES)))
    t0 = time.perf_counter()
    procs = []
    for rank in range(world):
        log = open(root / ('rank%d.log' % rank), 'w')
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / 'chip_smoke.py'), 'mesh-train-rank',
             str(rank), str(world), backend, str(root), DEVICE],
            stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    try:
        end = time.monotonic() + MESH_DEADLINE_S
        while True:
            codes = [p.poll() for p, _ in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > end:
                failed = [r for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    wall = time.perf_counter() - t0
    check(not failed, 'mesh ranks %s failed:\n%s' % (failed, '\n'.join(
        '--- rank %d ---\n%s' % (r, (root / ('rank%d.log' % r)).read_text()[
            -(4000 if r in failed else 1500):]) for r in range(world))))
    ranks = [json.loads((root / ('rank%d.json' % r)).read_text())
             for r in range(world)]
    for out in ranks:
        r, routes = out['rank'], out['routes']
        print('mesh rank %d %s: route vs one rank: code %.3g, encoder grads '
              '%.3g, CE sum %.3g, CE grads %.3g, top-1 agreement %.4f; '
              'padding shard (%d valid columns here) lse %.3g, grads %.3g; '
              'checks %.1f s' % (
                  r, tuple(out['coords']), routes['code_err'],
                  routes['encode_grad_err'], routes['ce_err'],
                  routes['ce_grad_err'], routes['top1_agree'],
                  routes['pad_shard_valid'], routes['pad_lse_err'],
                  routes['pad_grad_err'], out['routes_s']))
        print('mesh rank %d: route ms %s, plain ms %s (%d slots); each '
              'route against its plain version %s (limits %s; lse scale '
              '%.4g); the gather kernel bit for bit its plain version' % (
                  r, {k: round(v, 4) for k, v in routes['ms'].items()},
                  {k: round(v, 4) for k, v in routes['plain_ms'].items()},
                  routes['slots'],
                  {k: float('%.3g' % v)
                   for k, v in routes['plain_err'].items()},
                  MESH_PLAIN_LIMITS, routes['lse_scale']))
        plain = routes['plain_err']
        check(all(plain[k] <= limit for k, limit in MESH_PLAIN_LIMITS.items())
              and plain['b7_ce_fwd'] <= 1e-4 + 1e-4 * routes['lse_scale'],
              'rank %d: a mesh route disagrees with its plain version: %s'
              % (r, plain))
        check(routes['code_err'] <= MESH_CODE_LIMIT
              and routes['encode_grad_err'] <= MESH_GRAD_LIMIT
              and routes['ce_err'] <= MESH_CODE_LIMIT
              and routes['ce_grad_err'] <= MESH_CE_GRAD_LIMIT
              and routes['pad_lse_err'] <= MESH_CODE_LIMIT
              and routes['pad_grad_err'] <= MESH_CE_GRAD_LIMIT,
              'rank %d: a B7 route disagrees with the one-rank route beyond '
              'its limit (code %g, encoder grads %g, CE grads %g)'
              % (r, MESH_CODE_LIMIT, MESH_GRAD_LIMIT, MESH_CE_GRAD_LIMIT))
        check(routes['top1_agree'] >= MESH_TOP1_LIMIT,
              'rank %d: top-1 agreement %.4f under %.2f'
              % (r, routes['top1_agree'], MESH_TOP1_LIMIT))
        steps, counts = out['steps'], out['train_counts']
        check(steps == MESH_TRAIN_EPOCHS * (MESH_TRAIN_LINES // 1024),
              'rank %d took %d steps' % (r, steps))
        check_step_launches(counts, steps, 'mesh rank %d train()' % r)
        check(counts['gather'] == steps,
              'rank %d: the mesh\'s gather kernel launched %d times in %d '
              'steps' % (r, counts['gather'], steps))
        check(out['losses'][-1] < out['losses'][0]
              and all(math.isfinite(x) for x in out['losses']),
              'rank %d: the loss did not fall: %s' % (r, out['losses']))
        eval_steps = MESH_EVAL_LINES // 1024
        check(out['eval_counts']['ragged_fwd'] == eval_steps
              and out['eval_counts']['gather'] == eval_steps,
              'rank %d: evaluate() launches %s' % (r, out['eval_counts']))
        print('mesh rank %d: train() %d steps in %.1f s, epoch losses %s, '
              'step interval (median, ms) %s, peak %.2f GB allocated; '
              'launches %s; evaluate() top-1 %.4f F1 %.4f loss %.4f [%s]'
              % (r, steps, out['train_s'],
                 ['%.4f' % x for x in out['losses']],
                 ['%.1f' % x for x in out['interval_ms']],
                 out['peak_bytes'] / 1e9, counts, out['eval']['top1'],
                 out['eval']['f1'], out['eval']['loss'], gpu))
    check(len({out['dense_sha'] for out in ranks}) == 1,
          'the replicated weights differ across ranks after train()')
    knob_checks(ranks, gpu)
    # telemetry on the main path: each rank's files, each rank's MFU
    files = sorted(os.listdir(root / 'telemetry'))
    for out in ranks:
        r = out['rank']
        check(len(out['telemetry_files']) == 3 and out['mfu'] is not None
              and math.isfinite(out['mfu']) and out['mfu'] > 0,
              'rank %d: telemetry files %s, train/mfu %s'
              % (r, out['telemetry_files'], out['mfu']))
    print('mesh train: telemetry on train(): %s; train/mfu by rank %s '
          '(each rank\'s own step cost over one card\'s peak) [%s]'
          % (files, [round(out['mfu'], 5) for out in ranks], gpu))
    check(len({out['params_sha'] for out in ranks}) == 1,
          'the gathered tables differ across data rows')
    # the (2, 2) checkpoint restored on one rank
    t1 = time.perf_counter()
    one = Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), USE_PALLAS_FUSED_CE=True,
        MODEL_LOAD_PATH=str(root / 'checkpoint' / 'saved')), device=DEVICE)
    check(int(one.state.step) == ranks[0]['steps'],
          'restored step %d' % one.state.step)
    moments = lazy_adam.named_state(one.state.opt_state)
    params_sha, moments_sha = state_digests(
        one.backend.params._asdict(), moments,
        one.backend.sizes['target_vocab_size'])
    check(params_sha == ranks[0]['params_sha'],
          'the one-rank restore of the mesh checkpoint differs in params')
    check(moments_sha == ranks[0]['moments_sha'],
          'the one-rank restore of the mesh checkpoint differs in moments')
    del moments
    serve_launches = serve_comparisons(ranks, one, root, gpu)
    del one
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()
    print('mesh train: the (2, 2) checkpoint restores on one rank with equal '
          'params and moments (%.1f s); dense weights equal on every rank; '
          'the phase %.1f s [%s]' % (time.perf_counter() - t1,
                                     time.perf_counter() - t0, gpu))
    shutil.rmtree(root / 'checkpoint', ignore_errors=True)
    records = []
    main = ranks[0]['routes']
    for key, name, source, replaces, kernels in B7_ROUTES:
        bound_ms, bound_by = main['bound'][key]
        rec = record(name, source, replaces, main['plain_err'][key],
                     main['ms'][key], main['plain_ms'][key], bound_ms,
                     bound_by, None)
        # and against the one-rank route on the same global batch
        rec['one_rank_err'] = (
            main['code_err'] if key == 'b7_stats'
            else main['encode_grad_err'] if key == 'b7_grads'
            else main['ce_err'] if key == 'b7_ce_fwd'
            else main['ce_grad_err'])
        by_rank = [{k: out['train_counts'][k] + out['eval_counts'][k]
                    for k in kernels} for out in ranks]
        rec['launches'] = sum(c[kernels[0]] for c in by_rank)
        rec['launches_by_kernel'] = {k: sum(c[k] for c in by_rank)
                                     for k in kernels}
        rec['launches_by_rank'] = [c[kernels[0]] for c in by_rank]
        rec['ms_by_rank'] = [out['routes']['ms'][key] for out in ranks]
        rec['backend'] = backend
        records.append(rec)
    records += knob_records(ranks, backend)
    launches = {}
    for name in STEP_KERNELS + ('gather',):
        launches[name] = sum(out['train_counts'][name]
                             + out['eval_counts'][name] for out in ranks)
    # the knobs' own paths, summed over the ranks
    knob_paths = {
        'mesh_shard_contexts': [o['knobs']['shard_eval']['True']['counts']
                                for o in ranks],
        'mesh_zero': [o['knobs']['zero']['zero']['counts'] for o in ranks],
        'mesh_lazy': [o['knobs']['lazy']['counts'] for o in ranks],
        'mesh_fp32': [o['knobs']['fp32_train']['counts'] for o in ranks]}
    by_path = {path: {name: sum(c[name] for c in counts)
                      for name in counts[0]}
               for path, counts in knob_paths.items()}
    print('mesh train: wall %.1f s with %d ranks [%s]' % (wall, world, gpu))
    return {'records': records, 'launches': launches, 'by_path': by_path,
            'serve_launches': serve_launches}


def knob_checks(ranks, gpu: str) -> None:
    """The parent's checks and lines of ``mesh_knob_checks``' results: a
    rank's lines are printed before its checks run."""
    zero_steps = MESH_ZERO_STEPS
    for out in ranks:
        pending = []

        def defer(condition, message):
            pending.append((condition, message))

        def defer_steps(counts, steps, what):
            defer(all(counts[n] == steps for n in TRAIN_KERNELS)
                  and counts['adam_update'] == PARAMS_PER_STEP * steps,
                  '%s: kernel launches %s in %d train steps'
                  % (what, counts, steps))
        r, k = out['rank'], out['knobs']
        defer(k['shard_code_err'] <= MESH_SHARD_LIMITS['code']
              and k['shard_grad_err'] <= MESH_SHARD_LIMITS['grads'],
              'rank %d: SHARD_CONTEXTS against the unsharded route: code '
              '%.3g, gradients %.3g (limits %s)'
              % (r, k['shard_code_err'], k['shard_grad_err'],
                 MESH_SHARD_LIMITS))
        ev = k['shard_eval']
        loss_gap = abs(ev['True']['loss'] - ev['False']['loss']) / abs(
            ev['False']['loss'])
        defer(ev['True']['counts']['encode'] == MESH_EVAL_LINES // 1024
              and ev['False']['counts']['encode'] == MESH_EVAL_LINES // 1024
              and ev['True']['counts']['ragged_fwd'] == 0
              and loss_gap <= MESH_SHARD_LOSS_LIMIT,
              'rank %d: evaluate() on the plane wire: %s' % (r, ev))
        sl = k['slice_encode']
        defer(sl['err'] <= ENCODE_LIMIT,
              'rank %d: the encode kernel on a context slice against its '
              'plain version: %.3g' % (r, sl['err']))
        long = k['long']
        long_gap = abs(long['True']['loss'] - long['False']['loss']) / abs(
            long['False']['loss'])
        defer(all(math.isfinite(long[x]['loss']) for x in long)
              and long_gap <= MESH_SHARD_LOSS_LIMIT,
              'rank %d: the C = %d step: %s' % (r, MESH_LONG_CONTEXTS, long))
        print('mesh rank %d SHARD_CONTEXTS: against the unsharded route code '
              '%.3g, encoder gradients %.3g (limits %s); evaluate() loss '
              '%.6f sharded, %.6f not (top-1 %.4f, %.4f), encode launches '
              '%d a rank; the encode kernel on the %d rows of a context '
              'slice against its plain version %.3g; the C = %d step: loss '
              '%.6f sharded, %.6f not, peak allocated %.3f GB sharded, %.3f '
              'GB not (%.3f and %.3f GB above the state) [%s]'
              % (r, k['shard_code_err'], k['shard_grad_err'],
                 MESH_SHARD_LIMITS, ev['True']['loss'], ev['False']['loss'],
                 ev['True']['top1'], ev['False']['top1'],
                 ev['True']['counts']['encode'], sl['rows'], sl['err'],
                 MESH_LONG_CONTEXTS, long['True']['loss'],
                 long['False']['loss'], long['True']['peak'] / 1e9,
                 long['False']['peak'] / 1e9,
                 (long['True']['peak'] - long['True']['base']) / 1e9,
                 (long['False']['peak'] - long['False']['base']) / 1e9, gpu))
        zero, mirror = k['zero']['zero'], k['zero']['mirror']
        defer(zero['params_sha'] == mirror['params_sha']
              and zero['moments_sha'] == mirror['moments_sha']
              and zero['losses'] == mirror['losses'],
              'rank %d: \'zero\' differs from \'mirror\' after %d steps'
              % (r, zero_steps))
        defer_steps({n: zero['counts'][n] for n in STEP_KERNELS},
                            zero_steps, 'rank %d under \'zero\'' % r)
        print('mesh rank %d \'zero\' against \'mirror\', %d steps from one '
              'state: params and gathered moments bit for bit equal (losses '
              '%s); moments held %.3f GB (zero) against %.3f GB (mirror); '
              'peak allocated %.3f GB against %.3f GB (%.3f and %.3f GB '
              'above what was live before) [%s]'
              % (r, zero_steps, ['%.4f' % x for x in zero['losses']],
                 zero['moment_bytes'] / 1e9, mirror['moment_bytes'] / 1e9,
                 zero['peak'] / 1e9, mirror['peak'] / 1e9,
                 (zero['peak'] - zero['base']) / 1e9,
                 (mirror['peak'] - mirror['base']) / 1e9, gpu))
        lazy = k['lazy']
        rd = lazy['readings']
        defer(rd['weights'] <= RESUME_LIMITS['weights']
              and all(rd[mo]['scaled'] <= RESUME_LIMITS['scaled']
                      and rd[mo]['rel'] <= RESUME_LIMITS['rel']
                      and rd[mo]['scale'] <= RESUME_LIMITS['scale']
                      for mo in ('mu', 'nu')),
              'rank %d: lazy Adam on the mesh against the one-rank step: %s '
              '(limits %s)' % (r, rd, RESUME_LIMITS))
        defer(lazy['counts']['adam_rows'] == 2 * MESH_LAZY_STEPS
              and lazy['counts']['adam_update'] == 3 * MESH_LAZY_STEPS,
              'rank %d: lazy Adam launches %s' % (r, lazy['counts']))
        defer(all(u['moved'] == 0 and u['moments'] == 0
                  for u in lazy['untouched'].values()),
              'rank %d: lazy Adam moved rows no rank touched: %s'
              % (r, lazy['untouched']))
        rows = k['mesh_rows']
        defer(rows['mismatches'] == 0,
              'rank %d: adam_rows over the mesh\'s row mask differs from its '
              'plain version in %d elements' % (r, rows['mismatches']))
        print('mesh rank %d lazy Adam: against the one-rank step on the '
              'global batch %s (limits %s); untouched rows %s; adam_rows '
              'launched %d, adam_update %d; the row kernel over the mesh\'s '
              'mask (%d rows, %d touched) bit for bit its plain version '
              '[%s]' % (r, json.dumps(rd), RESUME_LIMITS,
                        lazy['untouched'], lazy['counts']['adam_rows'],
                        lazy['counts']['adam_update'], rows['listed'],
                        rows['rows'], gpu))
        fp32 = k['fp32']
        defer(k['fp32_code_err'] <= MESH_FP32_LIMITS['code']
              and k['fp32_grad_err'] <= MESH_FP32_LIMITS['grads']
              and fp32['plain_err']['fp32_stats'] <= MESH_FP32_LIMITS['code']
              and fp32['plain_err']['fp32_grads']
              <= MESH_FP32_LIMITS['grads'],
              'rank %d: an fp32 mesh route disagrees: one rank code %.3g, '
              'grads %.3g; plain %s (limits %s)'
              % (r, k['fp32_code_err'], k['fp32_grad_err'],
                 fp32['plain_err'], MESH_FP32_LIMITS))
        rc = fp32['route_counts']
        defer(rc['ragged_fwd'] == 1 and rc['ragged_bwd'] == 1
              and rc['gather'] == 1,
              'rank %d: the fp32 routes launched %s' % (r, rc))
        ft = k['fp32_train']
        steps = MESH_FP32_LINES // 1024
        defer(ft['steps'] == steps and all(math.isfinite(x)
                                           for x in ft['losses']),
              'rank %d: fp32 train(): %s' % (r, ft))
        defer_steps({n: ft['counts'][n] for n in STEP_KERNELS},
                            steps, 'rank %d fp32 train()' % r)
        defer(ft['counts']['gather'] == steps,
              'rank %d: fp32 train() gather launches %d'
              % (r, ft['counts']['gather']))
        print('mesh rank %d fp32: the routes against the one-rank fp32 route '
              'code %.3g, encoder gradients %.3g, against their plain '
              'versions %s (limits %s); the gather kernel\'s fp32 stream '
              'against its plain version %.3g of the scale (%d elements '
              'unequal; limit %.3g); route ms %s, plain ms %s; train() '
              '%d steps, losses %s, launches %s; the knobs %.1f s [%s]'
              % (r, k['fp32_code_err'], k['fp32_grad_err'],
                 {x: float('%.3g' % v) for x, v in fp32['plain_err'].items()},
                 MESH_FP32_LIMITS, k['fp32_gather_err'],
                 k['fp32_gather_unequal'], MESH_FP32_GATHER_LIMIT,
                 {x: round(v, 4) for x, v in fp32['ms'].items()},
                 {x: round(v, 4) for x, v in fp32['plain_ms'].items()},
                 ft['steps'], ['%.4f' % x for x in ft['losses']],
                 ft['counts'], out['knobs_s'], gpu))
        for condition, message in pending:
            check(condition, message)


def knob_records(ranks, backend: str) -> list:
    """The kernels-line records of the knobs' routes: rank 0's numbers,
    the launches summed over the ranks' paths."""
    main = ranks[0]['knobs']
    launches = {
        'fp32_stats': [o['knobs']['fp32_train']['counts']['ragged_fwd']
                       for o in ranks],
        'fp32_grads': [o['knobs']['fp32_train']['counts']['ragged_bwd']
                       for o in ranks],
        'slice_encode': [o['knobs']['shard_eval']['True']['counts']['encode']
                         for o in ranks],
        'mesh_rows': [o['knobs']['lazy']['counts']['adam_rows']
                      for o in ranks]}
    records = []
    for key, name, source, replaces in KNOB_ROUTES:
        if key.startswith('fp32'):
            fp32 = main['fp32']
            bound_ms, bound_by = fp32['bound'][key]
            rec = record(name, source, replaces, fp32['plain_err'][key],
                         fp32['ms'][key], fp32['plain_ms'][key], bound_ms,
                         bound_by, None)
            rec['one_rank_err'] = (main['fp32_code_err']
                                   if key == 'fp32_stats'
                                   else main['fp32_grad_err'])
            rec['ms_by_rank'] = [o['knobs']['fp32']['ms'][key] for o in ranks]
        else:
            part = main[key]
            bound_ms, bound_by = part['bound']
            rec = record(name, source, replaces, part['err'], part['ms'],
                         part['plain_ms'], bound_ms, bound_by,
                         part['library_ms'])
        rec['launches'] = sum(launches[key])
        rec['launches_by_rank'] = launches[key]
        rec['backend'] = backend
        records.append(rec)
    return records


def mesh_train_alone(argv) -> int:
    """``chip_smoke.py mesh-train-phase``: the kernels built, the java14m
    dictionary written, then ``mesh_train_phase``; no smoke's last line."""
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    started = time.perf_counter()
    gpu = device_lib.gpu_name_and_power_limit()
    print('gpu: %s; torch %s, CUDA %s' % (gpu, torch.__version__,
                                          torch.version.cuda))
    device_lib.disable_tf32()
    _build.build()
    base = Config()
    write_dict(SMOKE_DIR / 'java14m.dict.c2v', base.MAX_TOKEN_VOCAB_SIZE,
               base.MAX_PATH_VOCAB_SIZE, base.MAX_TARGET_VOCAB_SIZE)
    report = mesh_train_phase(gpu)
    print(json.dumps(report['records']))
    print('mesh train alone: %.1f s' % (time.perf_counter() - started))
    return 0


def reference_phase(rng) -> None:
    """A small model on the card vs the same weights on the CPU."""
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = SMOKE_DIR / 'small'
    write_dict(Path(str(prefix) + '.dict.c2v'), 300, 200, 50)
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    COMPUTE_DTYPE='float32')
    cpu = Code2VecModel(config, device='cpu', seed=3)
    weights = convert.params_to_numpy(cpu.backend.params)
    gpu = Code2VecModel(config, device='cuda',
                        params=convert.params_from_numpy(weights, 'cuda'))
    lines = make_lines(rng, 20, (299, 199, 49), config.MAX_CONTEXTS)
    want = cpu.predict(lines)
    got = gpu.predict(lines)
    for g, w in zip(got, want):
        check(g.topk_predicted_words == w.topk_predicted_words,
              'top-k words differ from the CPU reference')
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores,
                                   rtol=1e-4, atol=1e-5)
        check(g.attention_per_context.keys() == w.attention_per_context.keys(),
              'attention contexts differ')
        for key, value in w.attention_per_context.items():
            np.testing.assert_allclose(g.attention_per_context[key], value,
                                       rtol=1e-4, atol=1e-5)
    print('reference: %d predictions on the card match the CPU plain path '
          '(fp32, rtol 1e-4, atol 1e-5)' % len(lines))


def java14m_model() -> tuple:
    """The serving model at java14m width (its dictionary written under
    SMOKE_DIR, weights from seed 0, the defaults): (model, the dictionary's
    prefix, the test file's path, the serving config's keys)."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    base = Config()
    prefix = SMOKE_DIR / 'java14m'
    write_dict(Path(str(prefix) + '.dict.c2v'), base.MAX_TOKEN_VOCAB_SIZE,
               base.MAX_PATH_VOCAB_SIZE, base.MAX_TARGET_VOCAB_SIZE)
    test_path = Path(str(prefix) + '.test.c2v')
    serving = dict(TRAIN_DATA_PATH_PREFIX=str(prefix),
                   TEST_DATA_PATH=str(test_path))
    model = Code2VecModel(Config(**serving), device='cuda', seed=0)
    return model, prefix, test_path, serving


def mesh_serve_alone(argv) -> int:
    """``chip_smoke.py mesh-serve-phase``: the kernels built, the java14m
    model, then ``mesh_serve_phase``; no smoke's last line."""
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    started = time.perf_counter()
    gpu = device_lib.gpu_name_and_power_limit()
    print('gpu: %s; torch %s, CUDA %s' % (gpu, torch.__version__,
                                          torch.version.cuda))
    device_lib.disable_tf32()
    _build.build()
    print('mesh serve alone: %s' % mesh_serve_phase(java14m_model()[0], gpu))
    print('mesh serve alone: %.1f s' % (time.perf_counter() - started))
    return 0


def workloads_alone(argv) -> int:
    """``chip_smoke.py workloads-phase [--rate-scales S,...] [--seconds T]
    [--runs N]``: the kernels built, the java14m model, then
    ``workloads_phase`` N times with its paced replays at those rate
    scales and window; no smoke's last line."""
    import argparse
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import _build
    global WORKLOADS_RATE_SCALES, WORKLOADS_PACED_SECONDS
    parser = argparse.ArgumentParser(prog='chip_smoke.py workloads-phase')
    parser.add_argument('--rate-scales', default=','.join(
        '%g' % scale for scale in WORKLOADS_RATE_SCALES))
    parser.add_argument('--seconds', type=float,
                        default=WORKLOADS_PACED_SECONDS)
    parser.add_argument('--runs', type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    WORKLOADS_RATE_SCALES = tuple(float(x)
                                  for x in args.rate_scales.split(','))
    WORKLOADS_PACED_SECONDS = args.seconds
    started = time.perf_counter()
    gpu = device_lib.gpu_name_and_power_limit()
    print('gpu: %s; torch %s, CUDA %s' % (gpu, torch.__version__,
                                          torch.version.cuda))
    device_lib.disable_tf32()
    _build.build()
    model = java14m_model()[0]
    for run in range(args.runs):
        print('workloads alone, run %d of %d: %s' % (
            run + 1, args.runs, workloads_phase(model, gpu)), flush=True)
    print('workloads alone: %.1f s' % (time.perf_counter() - started))
    return 0

# the headline step's batches: full (fill 1.0), as the compute benchmarks'
BENCHLIB_BATCHES = 4


def benchlib_phase(gpu: str) -> dict:
    """The java14m headline step through the port's benchlib, one card,
    bf16 with the fused CE: ``build_trainer(headline_config(JAVA14M))``,
    full ``random_batches`` packed to one capacity (``pack_batches``) and
    staged (``staged``), ``bench_steps(False)`` warm-up and measured
    steps timed by ``bench_timer``; every step launches the four training
    kernels once and Adam once a parameter; ``kernels_engaged`` on one
    more step; the wire bytes of a batch at JAVA14M_FILL packed and as
    planes; then one eval step of ``build_eval_trainer``: the ragged
    forward once and no moment bytes allocated. Returns the launches of
    the phase's steps."""
    import torch
    from code2vec_tpu_torch import benchlib as bl
    from code2vec_tpu_torch.training.trainer import adam_params, moment_bytes
    t0 = time.perf_counter()
    shapes = bl.JAVA14M
    config = bl.headline_config(shapes, USE_PALLAS_FUSED_CE=True)
    torch.cuda.reset_peak_memory_stats()
    trainer, state = bl.build_trainer(config, shapes, seed=0)
    host = bl.random_batches(shapes, BENCHLIB_BATCHES, seed=0)
    packed = bl.pack_batches(host, trainer)
    capacity = packed[0].ctx.shape[1]
    check(all(p.ctx.shape[1] == capacity for p in packed),
          'benchlib: pack_batches gave more than one capacity')
    slots = int(sum(int(p.count.sum()) for p in packed) / len(packed))
    arrays = bl.staged(trainer, packed)
    warmup, measure = bl.bench_steps(False)
    sw = bl.bench_timer('benchlib/step')
    before = launch_counts()
    for i in range(warmup + measure):
        batch = arrays[i % len(arrays)]
        if i < warmup:
            state, loss = trainer.train_step_placed(state, batch)
        else:
            with sw.time():
                state, loss = trainer.train_step_placed(state, batch)
    loss = float(loss)
    check(math.isfinite(loss), 'benchlib: non-finite loss %r' % loss)
    counts = {name: n - before[name] for name, n in launch_counts().items()}
    check(counts['encode'] == 0 and counts['adam_rows'] == 0,
          'benchlib: the headline step launched %s' % counts)
    check_step_launches(counts, warmup + measure, 'benchlib headline steps')
    engaged = bl.kernels_engaged(trainer.train_step_placed, state,
                                 arrays[0])
    check_step_launches(engaged, 1, 'benchlib kernels_engaged')
    stats = sw.snapshot()
    step_ms = stats['p50_ms']
    examples_per_s = shapes.batch_size / (step_ms / 1e3)
    memory = bl.device_memory_record()
    peak_allocated = torch.cuda.max_memory_allocated()
    wire = bl.random_batches(shapes, 1, seed=1, fill=bl.JAVA14M_FILL)[0]
    plane_bytes = bl.wire_bytes(wire)
    packed_bytes = bl.wire_bytes(bl.pack_batches([wire], trainer)[0])
    check(packed_bytes < plane_bytes,
          'benchlib: packed wire %d bytes, planes %d' % (packed_bytes,
                                                          plane_bytes))
    del trainer, state, arrays
    torch.cuda.empty_cache()
    # eval only: the parameters and no moments
    held0 = torch.cuda.memory_allocated()
    eval_trainer, params = bl.build_eval_trainer(config, shapes, seed=0)
    held = torch.cuda.memory_allocated() - held0
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    shapes_by_name = {name: tuple(p.shape) for name, p in
                      zip(params._fields, params)}
    moments = adam_params(shapes_by_name) * moment_bytes(config)
    check(param_bytes <= held < param_bytes + (64 << 20),
          'benchlib: build_eval_trainer holds %d bytes for %d of '
          'parameters (moments would add %d)' % (held, param_bytes,
                                                  moments))
    eval_counts = bl.kernels_engaged(eval_trainer.eval_step, packed[0])
    check(eval_counts['ragged_fwd'] == 1 and eval_counts['ragged_bwd'] == 0
          and eval_counts['adam_update'] == 0 and eval_counts['ce_bwd'] == 0,
          'benchlib: one eval step launched %s' % eval_counts)
    del eval_trainer, params
    torch.cuda.empty_cache()
    total = {name: counts[name] + engaged[name] + eval_counts[name]
             for name in counts}
    print('benchlib: java14m headline step (bf16, fused CE, B=%d, fill 1.0, '
          '%d slots a batch, capacity %d): %d warm-up + %d measured steps, '
          'median %.4f ms (p95 %.4f, mean %.4f), %.0f examples/s, %.2fx the '
          'V100 baseline (%.0f/s); loss %.4f; memory %s, peak allocated %d; '
          'wire at fill %.2f: packed %d bytes, planes %d (%.3f); '
          'kernels_engaged %s; eval step %s; eval trainer %d bytes for %d '
          'of parameters (moments would be %d); %.1f s [%s]'
          % (shapes.batch_size, slots, capacity, warmup, measure, step_ms,
             stats['p95_ms'], stats['mean_ms'], examples_per_s,
             examples_per_s / bl.V100_BASELINE_EXAMPLES_PER_SEC,
             bl.V100_BASELINE_EXAMPLES_PER_SEC, loss, memory,
             peak_allocated, bl.JAVA14M_FILL, packed_bytes, plane_bytes,
             packed_bytes / plane_bytes, engaged, eval_counts, held,
             param_bytes, moments, time.perf_counter() - t0, gpu),
          flush=True)
    return total


def lint_phase() -> dict:
    """The port's static analysis (``code2vec_tpu_torch/analysis``) over
    this checkout: every rule, the port's baseline; fails on any finding
    that is neither suppressed nor baselined."""
    from code2vec_tpu_torch.analysis import engine
    report = engine.run(root=str(ROOT))
    for finding in report.findings:
        print('lint: ' + finding.format())
    print('lint: %d rules over %d files: %d finding(s), %d suppressed, %d '
          'baselined in %.2f s'
          % (len(report.rules_run), report.files_scanned,
             len(report.findings), len(report.suppressed),
             len(report.baselined), report.elapsed_s), flush=True)
    check(report.clean, 'lint: %d finding(s) not baselined'
          % len(report.findings))
    return {'rules': len(report.rules_run), 'findings': 0,
            'seconds': report.elapsed_s}


def benchlib_alone(argv) -> int:
    """``chip_smoke.py benchlib-phase``: the kernels built, then
    ``benchlib_phase``; no smoke's last line."""
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    started = time.perf_counter()
    gpu = device_lib.gpu_name_and_power_limit()
    print('gpu: %s; torch %s, CUDA %s' % (gpu, torch.__version__,
                                          torch.version.cuda))
    device_lib.disable_tf32()
    _build.build()
    print('benchlib alone: launches %s' % benchlib_phase(gpu))
    print('benchlib alone: %.1f s' % (time.perf_counter() - started))
    return 0


def lint_alone(argv) -> int:
    """``chip_smoke.py lint-phase``: ``lint_phase`` on the card's
    machine; no smoke's last line."""
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    print('lint alone: %s' % lint_phase())
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.ops import _build

    started = time.perf_counter()
    gpu = device_lib.gpu_name_and_power_limit()
    print('gpu: %s; torch %s, CUDA %s' % (gpu, torch.__version__,
                                          torch.version.cuda))
    device_lib.disable_tf32()

    def so_far(what: str) -> None:
        print('smoke: %.1f s in, after %s' % (time.perf_counter() - started,
                                             what), flush=True)

    t0 = time.perf_counter()
    report = _build.build()
    print('build: %.1f s for %s' % (time.perf_counter() - t0,
                                    sorted(report) or 'nothing (up to date)'))
    for name, info in report.items():
        for line in info['log'].splitlines():
            if any(k in line for k in ('registers', 'spill', 'warning')):
                print('  %s: %s' % (name, line.strip()))
    if 'ragged_fwd' in report:
        # the ragged forward's kernels: no spill, no serialized wgmma
        log = report['ragged_fwd']['log']
        check('C7514' not in log and all(
            line.strip().startswith('0 bytes stack frame')
            for line in log.splitlines() if 'bytes stack frame' in line),
            'ptxas reports a spill or a serialized wgmma in ragged_fwd.cu')
    # the port's static analysis over this checkout
    lint_phase()

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    base = Config()
    model, prefix, test_path, serving = java14m_model()
    table_bytes = sum(t.numel() * 4 for t in model.backend.params)
    print('model: java14m width, vocab %d/%d/%d, %.2f GB fp32 tables, '
          'bf16 compute, built in %.1f s'
          % (model.vocabs.token_vocab.size, model.vocabs.path_vocab.size,
             model.vocabs.target_vocab.size, table_bytes / 1e9,
             time.perf_counter() - t0))
    # the words in vocabulary (one index is the joined PAD/OOV word)
    vocab_sizes = (model.vocabs.token_vocab.size - 1,
                   model.vocabs.path_vocab.size - 1,
                   model.vocabs.target_vocab.size - 1)
    # the plane-wire and evaluation phases draw from their own generator,
    # so the other phases see the same data as before those phases existed
    rng_eval = np.random.default_rng(1)
    test_path.write_text('\n'.join(make_lines(
        rng_eval, EVAL_LINES, vocab_sizes, base.MAX_CONTEXTS)) + '\n')

    # the packed wire through the ragged kernel (the defaults)
    record = kernel_phase(model, rng, gpu)
    serving_launches = serving_phase(model, rng, gpu)
    breakdown_phase(model, rng, gpu)
    topk_phase(model, np.random.default_rng(2), gpu)
    reference_phase(rng)
    eval_ragged = evaluate_phase(model, gpu, 'ragged_fwd')
    eval_native = host_pipeline_phase(model, test_path, gpu)
    # the serving engine over the ladder of CUDA graphs, same weights
    so_far('the packed wire, kernels to evaluate and the host path')
    engine_report = engine_phase(model, np.random.default_rng(7), gpu)
    engine_telemetry_phase(model, np.random.default_rng(10), gpu)
    so_far('the engine')

    # the plane wire through the encode kernel, same weights
    planes = Code2VecModel(
        Config(BATCH_WIRE_FORMAT='planes', USE_PALLAS_FUSED_ENCODE=True,
               **serving), device='cuda', params=model.backend.params)
    encode_records = encode_kernel_phase(planes, rng_eval, gpu)
    planes_launches = serving_phase(planes, rng_eval, gpu,
                                    kernel='encode')
    breakdown_phase(planes, rng_eval, gpu)
    eval_encode = evaluate_phase(planes, gpu, 'encode')
    planes_engine = engine_planes_phase(planes, np.random.default_rng(8), gpu)
    torch.cuda.empty_cache()
    so_far('the plane wire')
    # the embedding index on the packed model: the bulk feed, the tiers,
    # neighbor queries through the engine and the CLI
    index_report = index_phase(model, gpu)
    torch.cuda.empty_cache()
    # the serving mesh: engine replicas behind one shared front queue, on
    # both wires
    mesh_report = mesh_phase(model, planes, gpu)
    # its worker modes: replicas in processes of their own
    worker_report = mesh_worker_phase(model, planes, gpu)
    # the elastic fleet: the autoscaler and a worker started outside
    elastic_report = mesh_elastic_phase(model, gpu)
    # fleet observability: the worker wire's spans, metrics and memory
    backhaul_report = mesh_backhaul_phase(model, gpu)
    # the scenario traffic plane: a mixed profile recorded and replayed,
    # retrieval-blended naming and canaried index rollovers on the mesh
    workloads_report = workloads_phase(model, gpu)
    # placement: socket workers pinned to a card each
    serve_report = mesh_serve_phase(model, gpu)
    del planes
    torch.cuda.empty_cache()
    # the packed wire unpacked on the card, then the encode kernel
    unpack = Code2VecModel(
        Config(USE_PALLAS_RAGGED_FUSION=False, USE_PALLAS_FUSED_ENCODE=True,
               **serving), device='cuda', params=model.backend.params)
    unpack_launches = serving_phase(unpack, rng_eval, gpu, kernel='encode',
                                    buckets=BUCKETS[1:])
    del unpack
    torch.cuda.empty_cache()
    eval_fp32_launches = evaluate_reference_phase(rng_eval)
    vocabs = model.vocabs
    del model
    torch.cuda.empty_cache()

    from code2vec_tpu_torch.models.backends import TorchBackend
    train_config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                          USE_PALLAS_FUSED_CE=True)
    backend = TorchBackend(train_config, vocabs, torch.device('cuda'), seed=1)
    check(backend.sizes['target_vocab_size'] == 262144,
          'fused-CE target rows %d' % backend.sizes['target_vocab_size'])
    train_records, train_fwd = train_kernel_phase(backend, rng, gpu)
    record.update(train_fwd)
    # the optimizer's kernels, on data of their own generators
    adam_record = adam_kernel_phase(backend, gpu)
    rows_record = adam_rows_phase(backend, np.random.default_rng(6), gpu)
    so_far('the unpacked wire, the train and optimizer kernels')
    records = [record] + encode_records + train_records + [adam_record,
                                                           rows_record]
    train_launches = train_phase(backend, rng, gpu)
    del backend
    torch.cuda.empty_cache()
    unfused = TorchBackend(Config(TRAIN_DATA_PATH_PREFIX=str(prefix)), vocabs,
                           torch.device('cuda'), seed=2)
    unfused_phase(unfused, rng, gpu)
    del unfused
    torch.cuda.empty_cache()
    # the fp32 training path (the CE kernels' three-term TF32 route), on
    # its own generator
    fp32_launches = train_fp32_phase(vocabs, prefix,
                                     np.random.default_rng(11), gpu)
    knob_launches = knob_phases(vocabs, prefix, gpu)
    so_far('train, the unfused CE, the optimizer knobs')
    # the java14m headline step through the port's benchlib
    knob_launches['benchlib'] = benchlib_phase(gpu)
    torch.cuda.empty_cache()
    so_far('the benchlib headline step')
    del vocabs
    torch.cuda.empty_cache()
    entry_launches = train_entry_phase(prefix, vocab_sizes, rng, gpu)
    pipeline_launches = train_pipeline_phase(
        vocab_sizes, np.random.default_rng(4), gpu)
    train_reference_phase(rng)
    so_far('train(), the host data path, the train reference')
    dense_launches = dense_route_phase(gpu)
    telemetry_launches = run_telemetry_phase(gpu)
    so_far('the dense routes and telemetry')
    checkpoint_launches = checkpoint_phase(prefix, test_path, gpu)
    cli_launches = cli_phase(np.random.default_rng(3), gpu)
    drill_launches = resilience_phase(np.random.default_rng(9), gpu)
    source_launches = source_to_repl_phase(np.random.default_rng(5), gpu)
    torch.cuda.empty_cache()
    so_far('checkpoints, the CLI, the drills, the path from source')
    # training and evaluation over a (2, 2) mesh of rank processes
    mesh_train = mesh_train_phase(gpu)
    records += mesh_train['records']

    # launches on the main paths, each counted from zero: serving
    # (predict) and evaluate on each route, and training (train_step,
    # then Code2VecModel.train())
    by_path = {'ragged_fwd': {'serving': serving_launches,
                              'eval': eval_ragged},
               'encode': {'serving_planes': planes_launches,
                          'serving_unpack': unpack_launches,
                          'eval_planes': eval_encode}}
    for counts in (train_launches, entry_launches):
        for name, n in counts.items():
            paths = by_path.setdefault(name, {})
            paths['train'] = paths.get('train', 0) + n
    # the checkpoint paths (train with saves, the reload's evaluate and
    # predict, the resumed train) and the CLI, each counted from zero
    # and the host data path's: evaluate() with the native reader, train()
    # from the token cache and from the native reader, the path from
    # source (train and evaluate through the CLI) and one shell turn
    by_path['ragged_fwd']['eval_native'] = eval_native
    # and the optimizer knobs' (train_lazy, train_grads_bf16, ...)
    # the fp32 training path's; its ragged forward, backward and CE
    # launches are the fp32 records' (below), another kernel than the bf16
    # rows'
    fp32_kernels = ('ragged_fwd', 'ragged_bwd', 'ce_fwd', 'ce_bwd')
    for name, n in fp32_launches.items():
        if name not in fp32_kernels:
            by_path.setdefault(name, {})['train_fp32'] = n
    for path, counts in dict(checkpoint_launches, cli=cli_launches,
                             **pipeline_launches, **dense_launches,
                             **telemetry_launches,
                             **drill_launches, **source_launches,
                             **knob_launches).items():
        for name in STEP_KERNELS + ('adam_rows',):
            if counts.get(name):
                by_path.setdefault(name, {})[path] = counts[name]
    # the engine paths: wrapper launches of their warm-up runs and
    # captures; their graph replays, which the counters cannot see
    by_path['ragged_fwd']['engine'] = engine_report['launches']
    by_path['encode']['engine_planes'] = planes_engine['launches']
    # the index paths: the bulk feed and the CLI's builds, the CLI's
    # queries, the neighbor engine's warm-up runs and captures
    by_path['ragged_fwd'].update(index_report['launches'])
    # the mesh paths: its replicas' warm-up runs and captures
    by_path['ragged_fwd']['mesh'] = mesh_report['launches']
    by_path['encode']['mesh_planes'] = mesh_report['plane_launches']
    # the worker paths: the launches of the workers' warm-ups, counted in
    # their own processes and read over the wire
    by_path['ragged_fwd']['mesh_process'] = worker_report['launches']
    by_path['encode']['mesh_process_planes'] = worker_report['plane_launches']
    by_path['ragged_fwd']['mesh_elastic'] = elastic_report['launches']
    by_path['ragged_fwd']['mesh_backhaul'] = backhaul_report['launches']
    by_path['ragged_fwd']['workloads'] = workloads_report['launches']
    by_path['ragged_fwd']['mesh_placed'] = serve_report['launches']
    # the serving paths across the mesh's ranks (summed): the bulk
    # export's ragged forward, predict's encode kernel
    by_path['ragged_fwd']['mesh_serve'] = \
        mesh_train['serve_launches']['ragged_fwd']
    by_path['encode']['mesh_serve'] = mesh_train['serve_launches']['encode']
    # the mesh phase's train() and evaluate(), summed over its ranks
    for name in STEP_KERNELS:
        by_path.setdefault(name, {})['mesh_train'] = \
            mesh_train['launches'][name]
    # the training knobs' paths on the mesh (SHARD_CONTEXTS' evaluate(),
    # 'zero', lazy Adam, fp32 train()), summed over its ranks
    # (the fp32 train()'s ragged forward, backward and CE launches are the
    # fp32 records', below)
    fp32_paths = {'train_fp32': fp32_launches,
                  'mesh_fp32': mesh_train['by_path'].get('mesh_fp32', {})}
    for path, counts in mesh_train['by_path'].items():
        for name, n in counts.items():
            if n and not (path in fp32_paths and name in fp32_kernels):
                by_path.setdefault(name, {})[path] = n
    replays = {'ragged_fwd': dict({'engine': engine_report['replays'],
                                   'mesh': mesh_report['replays'],
                                   'mesh_process': worker_report['replays'],
                                   'mesh_elastic': elastic_report['replays'],
                                   'mesh_backhaul':
                                       backhaul_report['replays'],
                                   'workloads': workloads_report['replays'],
                                   'mesh_placed': serve_report['replays']},
                                  **index_report['replays']),
               'encode': {'engine_planes': planes_engine['replays'],
                          'mesh_planes': mesh_report['plane_replays'],
                          'mesh_process_planes':
                              worker_report['plane_replays']}}
    for rec in records:
        if rec['name'] in ('ragged_fwd_fp32', 'ragged_bwd_fp32',
                           'ce_fwd_fp32', 'ce_bwd_fp32'):
            # the fp32 training kernels: their launches on the fp32
            # training paths (one card, and the mesh's fp32 train() over
            # its ranks)
            wrapper = rec['name'][:-len('_fp32')]
            rec['launches_by_path'] = {
                path: counts.get(wrapper, 0)
                for path, counts in fp32_paths.items()}
            rec['launches'] = sum(rec['launches_by_path'].values())
            continue
        if rec['name'] == 'encode_fp32':
            # the fp32 encode: the card's plane-wire evaluate() at
            # COMPUTE_DTYPE float32 (evaluate_reference_phase)
            rec['launches_by_path'] = {'eval_planes_fp32':
                                       eval_fp32_launches}
            rec['launches'] = eval_fp32_launches
            continue
        if rec['name'] not in by_path:
            continue       # a mesh route: its launches are the ranks' own
        rec['launches'] = sum(by_path[rec['name']].values())
        rec['launches_by_path'] = by_path[rec['name']]
        rec['graph_replays_by_path'] = replays.get(rec['name'], {})
    print('smoke: every phase passed in %.1f s' % (time.perf_counter()
                                                   - started))
    print(json.dumps({'kernels': records}))
    print(gpu)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:] == ['telemetry-phase']:
        sys.exit(telemetry_phase_child())
    if sys.argv[1:2] == ['mesh-train-rank']:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    if sys.argv[1:] == ['mesh-train-phase']:
        sys.exit(mesh_train_alone(sys.argv[2:]))
    if sys.argv[1:2] == ['workloads-phase']:
        sys.exit(workloads_alone(sys.argv[2:]))
    if sys.argv[1:] == ['mesh-serve-phase']:
        sys.exit(mesh_serve_alone(sys.argv[2:]))
    if sys.argv[1:] == ['benchlib-phase']:
        sys.exit(benchlib_alone(sys.argv[2:]))
    if sys.argv[1:] == ['lint-phase']:
        sys.exit(lint_alone(sys.argv[2:]))
    sys.exit(main())
