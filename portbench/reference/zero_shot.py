"""Reference zero-shot classification of raw event streams.

EventCLIP's ZSCLIP (`models/clip_cls.py`): every view of a stream goes
through the image tower; the raw (not normalised) image feature is scored
against the L2-normalised class text features, times the logit scale; the
stream's probabilities are the mean over its views of each view's softmax.
Views are encoded in blocks so that a full-width tower fits beside
nothing else.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from . import frames, vit, windows


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def stream_probs(streams: List[np.ndarray], weights: Dict[str, torch.Tensor],
                 text_feats: torch.Tensor, geo: Dict[str, Any],
                 block: int = 64, rnd=vit.exact) -> np.ndarray:
    """[n] raw streams -> [n, n_classes] float32 probabilities.

    geo: height, width, window, views, layers, heads, image_size,
    logit_scale, thresh, grey. `rnd`: the tower's storage rounding
    (`vit.to_bf16` for the configuration's bfloat16)."""
    tf32_off()
    device = text_feats.device
    views, owner = [], []
    for i, s in enumerate(streams):
        w = windows.stream_windows(s, geo["height"], geo["width"],
                                   geo["window"], geo["views"])
        views += w
        owner += [i] * len(w)
    feats = []
    for a in range(0, len(views), block):
        hist = frames.histograms(views[a:a + block], geo["height"],
                                 geo["width"], device)
        img = frames.frames(hist, geo["thresh"], geo["grey"])
        x = frames.clip_inputs(img, geo["image_size"])
        feats.append(vit.encode(x, weights, geo["layers"], geo["heads"],
                                rnd))
    logits = geo["logit_scale"] * torch.cat(feats) @ text_feats.T
    p = torch.softmax(logits, dim=-1)
    owner_t = torch.tensor(owner, device=device)
    out = torch.zeros((len(streams), p.shape[-1]), device=device)
    out.index_add_(0, owner_t, p)
    counts = torch.bincount(owner_t, minlength=len(streams)).float()
    return (out / counts[:, None]).cpu().numpy()
