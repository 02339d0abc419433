"""Sharding rules and overlap utilities of the port (mirrors
``repro/parallel``; ``compat.py``, a jax-version shim, has no
counterpart)."""
