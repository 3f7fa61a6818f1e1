"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it, and their launch counters.  No kernel has a backward
pass: every wrapper refuses an input that requires grad while grad mode
is on (``_build.refuse_autograd``), on the card and on the CPU alike."""

from repro_torch.kernels._build import (build_all, launches,  # noqa: F401
                                        reset_launches)
