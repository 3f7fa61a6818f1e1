"""Process-level launch of the port: the tensor-parallel mesh and the
serving steps."""
