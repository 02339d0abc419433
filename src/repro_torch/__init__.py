"""PyTorch/CUDA port of ``repro`` (the JAX/Pallas package beside it).

Laid out module for module like ``src/repro/``: each port module names the
reference file it mirrors.  The port imports ``torch`` and never ``jax``
or ``repro``; numpy-only reference modules are copied in.  Every Pallas
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``kernels/csrc/``) with a plain-torch twin in ``kernels/ref.py``.

Public entry point: :func:`repro_torch.euler.solve` /
:class:`repro_torch.euler.EulerSolver`, which run on ``"cuda"`` unless the
caller passes ``device="cpu"``.
"""
