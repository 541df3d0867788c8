"""Tile math (plain PyTorch versions of the CUDA tile bodies)."""
