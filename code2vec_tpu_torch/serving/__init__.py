"""Serving: the predict step and its tiers (``steps``), the bucket ladder
and decode (``engine``), and prediction reports (``predict``)."""
