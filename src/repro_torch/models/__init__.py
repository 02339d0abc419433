"""Model code of the port (mirrors ``repro/models``): the dense decoder LM
that the serving path runs."""
