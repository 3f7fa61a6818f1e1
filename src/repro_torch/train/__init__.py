"""Training loop of the port with checkpointing, heartbeats, straggler and
elastic hooks."""

from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
