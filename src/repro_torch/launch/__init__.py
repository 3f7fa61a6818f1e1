"""Process-level launch of the port: the tensor-parallel mesh, the train
step and the serving steps."""
