"""In-process dynamic-batching inference server."""
