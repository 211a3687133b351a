"""Training data: the classical LR degradation on the device, the
paired (LPSR) and unpaired (CycleGAN) image folders and the CycleGAN
history pool; the detector's YOLO dataset with its augmentation on the
host library ``csrc/host_augment.cc`` (plain numpy versions in
``cv_plain``)."""
