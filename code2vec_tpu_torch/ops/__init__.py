"""Device operations: the ragged encode (``ragged``, with its Hopper
kernel under ``csrc/``) and top-k (``topk``)."""
