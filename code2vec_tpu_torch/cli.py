"""The port's command line, dispatching as ``code2vec_tpu/cli.py`` does.

    python -m code2vec_tpu_torch.cli --data ds --test ds.val.c2v --save models/m/s
    python -m code2vec_tpu_torch.cli --load models/m/s --test ds.test.c2v
    python -m code2vec_tpu_torch.cli --load models/m/s --predict [--input-file X.cs]
    python -m code2vec_tpu_torch.cli --load models/m/s --release
    python -m code2vec_tpu_torch.cli --load models/m/s --save_word2v tokens.txt
    python -m code2vec_tpu_torch.cli --load models/m/s --bulk-vectors corpus.c2v
    python -m code2vec_tpu_torch.cli --load models/m/s --build-index corpus.c2v \
        [--index-kind ivf | --index-quant pq] --query-neighbors q.c2v

Runs on the card; ``--device cpu`` runs the kernels' plain versions on
the CPU. ``-lp FILE`` mirrors the log into FILE; ``-tb`` writes the
training scalars into ``summaries/`` beside the model; the resilience
flags (``--save-every-steps``, ``--no-divergence-guard``,
``--max-divergence-rewinds``, ``--watchdog-secs``, ``--fault-inject``)
are the JAX CLI's. Training evaluates per epoch, so ``--test``
evaluates on its own only without ``--data``. ``--predict`` runs the interactive shell over
PREDICT_INPUT_PATH (``serving/predict.py``), with the checkout's
extractor built at first use. ``--serving-buckets``,
``--serving-max-delay-ms``, ``--serving-deadline-ms``,
``--serving-queue-bound`` and ``--serve-follow-checkpoints`` configure
the serving engine that ``Code2VecModel.serving_engine()`` builds, as in
the JAX package, whose command line starts no engine either. The
telemetry flags are the JAX CLI's: ``--telemetry``, ``--telemetry-dir``,
``--trace-at-step``, ``--device-peak-flops``, ``--hbm-budget-bytes``,
``--profile``, and ``--memory-report``, which writes
``memory_report.json`` when the work is done. ``--build-index SOURCE``
builds an embedding index (``index/service.py``: a ``.c2v`` corpus
through the vectors tier, a ``.vectors`` export or a word2vec file) and
``--query-neighbors FILE.c2v`` writes ``FILE.c2v.neighbors.jsonl``; the
index flags are the JAX CLI's.

Over several ranks (``parallel/``):

    torchrun --nproc-per-node 4 -m code2vec_tpu_torch.cli --mesh 2x2 \
        --data ds --test ds.val.c2v --save models/m/s \
        --opt-state-sharding zero --telemetry

Every rank joins the world first (``maybe_initialize_distributed``, as
the JAX CLI joins ``jax.distributed``; nccl, one card a rank, unless
``--dist-backend gloo`` names gloo) and lays it out as ``--mesh
DATAxMODEL``; training, evaluation, ``--release`` and the word2vec
exports run on the mesh, rank 0 writing the files, with every training
knob (``--opt-state-sharding zero``, SHARD_CONTEXTS, lazy Adam, fp32).
Under ``--telemetry`` every rank writes into the one telemetry directory
(``--telemetry-dir``, else beside the model), rank r > 0 under
``.proc<r>`` names (``metrics.proc1.jsonl``, ``traces/step8.proc1/``).
``--predict``, ``--bulk-vectors``, ``--build-index`` and
``--query-neighbors`` run on the mesh of one host's ranks too, as the JAX
CLI runs them on one host's devices: every rank runs them, each on its
data shard, and the chief writes the output, which is the one-rank
output in corpus order (the shell: the chief reads the input and runs
the extractor, the ranks predict each turn together):

    torchrun --nproc-per-node 4 -m code2vec_tpu_torch.cli --mesh 2x2 \
        --load models/m/s --bulk-vectors corpus.c2v \
        --build-index corpus.c2v --query-neighbors q.c2v

A world whose ranks span hosts refuses them, as the JAX CLI's
single-host guard does. The serving engine and the serving mesh stay on
one rank (ROADMAP C15): they serve several cards by placement, one
worker replica a card (MESH_DEVICES_PER_REPLICA=1, in 'process' or
'socket' mode; ``serving/mesh_worker.py --device-indices``).
MESH_DEVICE_INDICES puts local rank r on card ``indices[r]``.
"""
from __future__ import annotations

import logging
from typing import List, Optional

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.vocab import VocabType

logger = logging.getLogger('code2vec_tpu_torch')


_FORMAT = '%(asctime)s %(levelname)s %(message)s'


def _configure_logging(config: Config) -> None:
    """The package's log on stderr at VERBOSE_MODE, and mirrored into
    LOGS_PATH (``-lp``) at INFO, as the reference's ``Config.get_logger``
    mirrors it."""
    logger.setLevel(logging.INFO)
    for handler in list(logger.handlers):
        if isinstance(handler, logging.FileHandler):
            logger.removeHandler(handler)
            handler.close()
    stream = [h for h in logger.handlers
              if isinstance(h, logging.StreamHandler)]
    if not stream:
        stream = [logging.StreamHandler()]
        stream[0].setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(stream[0])
    stream[0].setLevel(logging.INFO if config.VERBOSE_MODE > 0
                       else logging.WARNING)
    if config.LOGS_PATH:
        file_handler = logging.FileHandler(config.LOGS_PATH)
        file_handler.setLevel(logging.INFO)
        file_handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(file_handler)


def main(args: Optional[List[str]] = None):
    """Parse ``args`` (default ``sys.argv``), run what they ask, and return
    the model."""
    config = Config().load_from_args(args)
    _configure_logging(config)

    from code2vec_tpu_torch.parallel import distributed
    distributed.maybe_initialize_distributed(
        backend=config.DIST_BACKEND, log=logger.info,
        device_indices=config.MESH_DEVICE_INDICES)
    from code2vec_tpu_torch.model_api import Code2VecModel
    model = Code2VecModel(config)     # verifies the config
    logger.info('Done creating code2vec model on %s', model.device)

    if config.is_training:
        model.train()
    if config.SAVE_W2V is not None:
        model.save_word2vec_format(config.SAVE_W2V, VocabType.Token)
    if config.SAVE_T2V is not None:
        model.save_word2vec_format(config.SAVE_T2V, VocabType.Target)
    if config.EXPORT_VOCAB_VECTORS:
        prefix = config.EXPORT_VOCAB_VECTORS
        model.save_word2vec_format(prefix + '.tokens.txt', VocabType.Token)
        model.save_word2vec_format(prefix + '.targets.txt',
                                   VocabType.Target)
    if config.BULK_VECTORS_PATH:
        from code2vec_tpu_torch.serving.bulk import export_code_vectors
        export_code_vectors(model, config.BULK_VECTORS_PATH)
    # the embedding index: build, then batch neighbor queries (index/)
    index = None
    if config.BUILD_INDEX_FROM:
        from code2vec_tpu_torch.index.service import build_index
        index = build_index(model, config)
    if config.QUERY_NEIGHBORS_PATH:
        from code2vec_tpu_torch.index.service import query_neighbors_file
        query_neighbors_file(model, config, index=index)
    if config.is_testing and not config.is_training:
        results = model.evaluate()
        logger.info(str(results).replace('topk', 'top%d' % (
            config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION)))
    if config.PREDICT:
        from code2vec_tpu_torch.serving.predict import InteractivePredictor
        InteractivePredictor(config, model).predict()
    if config.RELEASE and config.is_loading:
        model.release_model()
    # --memory-report: a reconciled memory-ledger snapshot of whatever
    # this invocation ran (telemetry/memory.py; scripts/memory_report.py)
    if config.MEMORY_REPORT:
        from code2vec_tpu_torch.telemetry import memory as memory_lib
        memory_lib.write_report(config)
    return model


if __name__ == '__main__':
    main()
