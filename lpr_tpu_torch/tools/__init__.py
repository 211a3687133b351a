"""Tools for running and measuring the port on the card: synthetic frames
made with numpy, and the profilers (by kernel, by stage of the step, by
detector layer, K1 and K2 by internal stage) with their shared timing,
the training steps' time (``bench_train_step``) and the detector
loader's throughput (``bench_input``)."""
