"""Batched LM serving on the PyTorch port: prefill + KV-cache decode
(mirrors ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

It runs on ``cuda`` unless given ``--device cpu``.
"""
import sys

from repro_torch.launch.serve import main_lm as main

main(["--arch", "smollm-360m", "--batch", "4", "--prompt-len", "32",
      "--gen", "16", *sys.argv[1:]])
