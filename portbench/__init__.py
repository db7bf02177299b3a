"""portbench: the benchmark of the PyTorch/CUDA port `eventclip_tpu_torch`
(see README.md)."""
