"""Training of the port (the s2a slice): optimizer, trainer, checkpoints,
exported model directories and the ``run_s2a`` entry point."""
