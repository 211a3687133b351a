"""Models: the YOLO detectors and LPSR, as ``torch.nn.Module``s."""
