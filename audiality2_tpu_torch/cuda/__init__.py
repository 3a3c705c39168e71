"""PyTorch/CUDA device path: the superblock program builder, the
oscillator kernel and the superblock mixer."""
