"""Command-line apps: run, sr, serve, evaluate and find_improvement, each
``python -m lpr_tpu_torch.cli.<name>``; on the card unless given
``--device cpu``."""
