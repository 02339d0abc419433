"""Command-line entry points of the port (mirrors ``repro/launch``)."""
