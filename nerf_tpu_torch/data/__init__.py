"""Dataset loading."""
