"""Architecture configs of the port (mirrors ``repro/configs``), with
torch dtypes in place of the reference's ``jax.numpy`` ones."""
