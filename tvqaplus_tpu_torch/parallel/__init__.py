"""Parallelism: the data axis of the JAX package's device mesh over
processes (``mesh.py``)."""
