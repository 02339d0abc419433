"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers and the
plain-torch twins they are held against (mirrors ``repro/kernels``)."""
