"""Command-line apps: run, sr, serve, evaluate, find_improvement, export,
and the training apps create_lr, train_lpsr, train_cyclegan and
train_yolo, each ``python -m lpr_tpu_torch.cli.<name>``; on the card
unless given ``--device cpu``."""
