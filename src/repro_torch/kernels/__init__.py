"""Hand-written Hopper kernels of the port, each beside its plain version.

`_cuda` builds, loads, launches and counts the CUDA kernels; each kernel
module declares its own source and C interface there.
"""


def not_in_slice(autotune: bool = False, n_columns: int = 1,
                 column_weights=None) -> None:
    """Raise `NotImplementedError` for the options whose port comes in a
    later slice."""
    if autotune:
        raise NotImplementedError(
            "autotune=True comes with the port of core/autotune.py (timed "
            "with CUDA events), a later slice")
    if n_columns != 1 or column_weights is not None:
        raise NotImplementedError(
            "n_columns > 1 / column_weights come with the port of the "
            "column deal (kernels/pipeline/shard.py), a later slice")
