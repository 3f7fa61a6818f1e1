"""Data pipeline of the port: synthetic-but-learnable LM streams, sharded
and prefetched (numpy, as the reference's)."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    make_batches,
    synthetic_stream,
)
