"""Checkpoints, image output and the PNG codec."""
