"""End-to-end LM training on the PyTorch port (mirrors
``examples/train_lm.py``): the reduced SmolLM-360M config, 120 steps with
checkpointing, an injected failure at step 60 and the restart from the
step-40 checkpoint — the full driver.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]

It runs on ``cuda`` unless given ``--device cpu``; further arguments go
to ``repro_torch.launch.train``.  Its checkpoints go to a fresh temporary
directory, removed at the end, unless ``--ckpt-dir`` names one: the
trainer resumes from the latest step it finds in its directory, so a
second run in a used one would skip the steps the first run saved.
"""
import shutil
import sys
import tempfile

from repro_torch.launch.train import main

own_dir = None if "--ckpt-dir" in sys.argv[1:] else \
    tempfile.mkdtemp(prefix="repro-torch-example-ckpt-")
try:
    losses = main([
        "--arch", "smollm-360m", "--steps", "120", "--batch", "4",
        "--seq", "64", "--ckpt-every", "40", "--fail-at", "60",
        *(["--ckpt-dir", own_dir] if own_dir else []), *sys.argv[1:],
    ])
finally:
    if own_dir:
        shutil.rmtree(own_dir, ignore_errors=True)
print(f"final loss {losses[-1]:.3f} (from {losses[0]:.3f}) "
      f"after surviving an injected failure at step 60")
