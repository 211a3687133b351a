"""The enhancement stage's trainers: LPSR (MSE, Adam, plateau learning
rate; validation through K2's float32 instance) and the degradation
CycleGAN, with their per-epoch image grids."""
