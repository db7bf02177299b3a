"""Device ops: the event histogram and fused-qkv attention kernels with
their plain PyTorch versions, the frame finish stage and CLIP preprocess.

Importing the package registers the kernels as `torch.library` custom ops
(custom_ops.py), which the wrappers in attention.py and rasterize.py
call."""

from . import custom_ops  # noqa: F401  (registers eventclip::*)
