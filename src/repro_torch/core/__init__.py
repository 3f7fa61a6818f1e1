"""Monarch core of the port: dims, products, the unified linear layer."""

from repro_torch.core.linear import (MonarchSpec, linear_apply,  # noqa: F401
                                     linear_init)
from repro_torch.core.monarch import (MonarchDims, make_dims,  # noqa: F401
                                      monarch_multiply, monarch_to_dense)
