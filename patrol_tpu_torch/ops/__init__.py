"""Pure computational ops: rate algebra, wire codec, and the take and join kernels with their plain PyTorch versions."""
