"""Checkpointing of the port: atomic save/restore with integrity checks, on
the reference's on-disk layout."""

from repro_torch.checkpoint.store import (  # noqa: F401
    latest_step,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
)
