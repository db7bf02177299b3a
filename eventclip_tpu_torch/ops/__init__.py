"""Device ops: the event histogram and fused-qkv attention kernels with
their plain PyTorch versions, the frame finish stage and CLIP preprocess."""
