"""The trainers: the enhancement stage's LPSR (MSE, Adam, plateau learning
rate; validation through K2's float32 instance) and degradation CycleGAN,
with their per-epoch image grids; the YOLO detectors' (SGD + EMA, the
YOLOv5 loss, validation mAP)."""
