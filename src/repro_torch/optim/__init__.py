"""Optimizers and LR schedules of the port (``repro.optim``'s): AdamW over
nested dicts of tensors, functional, and the cosine and WSD schedules."""

from repro_torch.optim.adamw import (adamw, apply_updates,  # noqa: F401
                                     clip_by_global_norm)
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         wsd_schedule)
