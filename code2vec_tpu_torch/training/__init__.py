"""Training: the Adam update with narrowed moment storage
(``adam_dtypes``) and the train step (``trainer``)."""
