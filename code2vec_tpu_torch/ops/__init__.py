"""Device operations: the ragged encode (``ragged``, with its Hopper
kernel under ``csrc/``) and top-k (``topk``).

Each kernel wrapper adds one to its module's counter where it launches
its kernel (never in its plain version); ``launch_counts`` reads them all
and ``zero_launch_counts`` sets them to 0 (``chip_smoke.py`` and
``benchlib.kernels_engaged``)."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from code2vec_tpu_torch.ops import adam, ce, encode, ragged
    return {'ragged_fwd': ragged.launches, 'ragged_bwd': ragged.bwd_launches,
            'ce_fwd': ce.fwd_launches, 'ce_bwd': ce.bwd_launches,
            'encode': encode.launches, 'adam_update': adam.launches,
            'adam_rows': adam.row_launches}


def zero_launch_counts() -> None:
    """Every counter of ``launch_counts`` to 0."""
    from code2vec_tpu_torch.ops import adam, ce, encode, ragged
    ragged.launches = ragged.bwd_launches = 0
    ce.fwd_launches = ce.bwd_launches = 0
    encode.launches = 0
    adam.launches = adam.row_launches = 0
