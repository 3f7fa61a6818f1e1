"""Tensor-parallel placement of the port: parameter rules and the
collectives explicit SPMD needs."""
