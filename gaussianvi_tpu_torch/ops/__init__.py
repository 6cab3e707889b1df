"""Small-block and block-tridiagonal algebra (plain PyTorch)."""
