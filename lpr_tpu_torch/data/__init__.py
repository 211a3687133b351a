"""Training data: the classical LR degradation on the device, the
paired (LPSR) and unpaired (CycleGAN) image folders and the CycleGAN
history pool."""
