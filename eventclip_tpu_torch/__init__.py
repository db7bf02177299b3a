"""PyTorch / CUDA port of eventclip_tpu for NVIDIA Hopper (H100).

The JAX package beside this one (`eventclip_tpu/`) is the reference; this
package mirrors its module names so each counterpart is easy to find, and
imports only torch, numpy and the standard library — never JAX and never
anything of `eventclip_tpu`.

Ported so far: zero-shot serving (`serve.Predictor`): raw event streams ->
host windowing -> event histogram (CUDA kernel, csrc/histogram.cu) -> frame
finish + CLIP preprocess -> CLIP ViT with the fused-qkv attention kernel
(csrc/attention.cu) -> class probabilities against text-tower features;
FTCLIP fine-tuning and FSCLIP few-shot training on one device
(`engine.trainer.EventCLIPTrainer`), whose backward runs the attention
backward kernel (csrc/attention_bwd.cu); and the path from files on disk
to an accuracy: the dataset readers (`data.datasets`), the BPE tokenizer,
OpenAI CLIP `.pt` and reference method `.pth` loading, and the train /
test CLIs (`python -m eventclip_tpu_torch.cli.train` / `.cli.test`); and
the rest of serving: the native host ops (`native`, a fused C++ pass built
by g++ at first use, with the numpy path as the fallback), trained-weight
serving, the W8A8 int8 tower (`ops.quant`), token pruning, embeddings,
label swaps, `serve.StreamSession` and the offline serve CLI
(`python -m eventclip_tpu_torch.serve`); the ResNet towers and
pseudo-labelling (`cli.gen_data`); and the HTTP endpoint (`server`, with
its `client`) and frozen export bundles (`export`), with every kernel a
`torch.library` custom op (`ops.custom_ops`).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; on CPU tensors every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"
