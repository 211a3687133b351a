"""Plain-Python utilities: the local run-artifact registry, the training
guards, hooks, loggers, AutoAnchor and hyperparameter evolution."""
