"""PyTorch / CUDA port of eventclip_tpu for NVIDIA Hopper (H100).

The JAX package beside this one (`eventclip_tpu/`) is the reference; this
package mirrors its module names so each counterpart is easy to find, and
imports only torch, numpy and the standard library — never JAX and never
anything of `eventclip_tpu`.

Ported so far: zero-shot serving (`serve.Predictor`): raw event streams ->
host windowing -> event histogram (CUDA kernel, csrc/histogram.cu) -> frame
finish + CLIP preprocess -> CLIP ViT with the fused-qkv attention kernel
(csrc/attention.cu) -> class probabilities against text-tower features.

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; on CPU tensors every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"
