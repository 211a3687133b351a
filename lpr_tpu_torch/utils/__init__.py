"""Plain-Python utilities: the local run-artifact registry."""
