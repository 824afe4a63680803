"""Serving: the predict step and its tiers (``steps``), the micro-batching
engine (``engine``) over its ladder of CUDA graphs (``graphs``), the
typed errors (``errors``), and prediction reports (``predict``)."""
