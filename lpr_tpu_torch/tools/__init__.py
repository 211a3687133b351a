"""Tools for running and measuring the port on the card: synthetic frames
made with numpy, and a step profiler."""
