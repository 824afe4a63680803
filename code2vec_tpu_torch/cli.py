"""The port's command line, dispatching as ``code2vec_tpu/cli.py`` does.

    python -m code2vec_tpu_torch.cli --data ds --test ds.val.c2v --save models/m/s
    python -m code2vec_tpu_torch.cli --load models/m/s --test ds.test.c2v
    python -m code2vec_tpu_torch.cli --load models/m/s --predict [--input-file X.cs]
    python -m code2vec_tpu_torch.cli --load models/m/s --release
    python -m code2vec_tpu_torch.cli --load models/m/s --save_word2v tokens.txt
    python -m code2vec_tpu_torch.cli --load models/m/s --bulk-vectors corpus.c2v

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
``memory_report.json`` when the work is done. ``--build-index`` and
``--query-neighbors`` are not ported yet and are argparse errors that
say so (``config.py``).
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
