"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it, and their launch counters."""

from repro_torch.kernels._build import (build_all, launches,  # noqa: F401
                                        reset_launches)
