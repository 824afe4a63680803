"""Serving: the predict step and its tiers (``steps``), the micro-batching
engine (``engine``) over its ladder of CUDA graphs (``graphs``), the
serving mesh of engine replicas (``mesh``) with its shared front queue
(``frontqueue``), memo tier (``memo``) and SLO monitor (``slo``), the
typed errors (``errors``), and prediction reports (``predict``)."""
