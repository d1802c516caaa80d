"""Ray, encoding, sampling and compositing math in plain PyTorch."""
