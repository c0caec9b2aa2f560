"""Tensor-parallel serving layout of the port: spec data (`specs`) and a
rank's mesh context with its collectives (`ctx`)."""
