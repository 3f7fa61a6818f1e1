"""Attention-stack model code of the port."""
