"""Validation-time event visualization (reference method.py:71-148).

Port of eventclip_tpu/utils/viz.py. For a few uniformly-sampled val items,
(a) the raw event stream rendered to a bordered video and (b) the
model-input frames, captioned with the ground truth and top-3
predictions, are written as GIFs plus a captions.json under
<ckpt_dir>/viz/epoch_<k>/. PIL is imported only by `save_gif`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# the normalization constants live with the preprocess op; a drift
# between normalize and denormalize would silently skew saved GIFs
from ..ops.preprocess import CLIP_MEAN as _MEAN, CLIP_STD as _STD

CLIP_MEAN = np.asarray(_MEAN, np.float32)
CLIP_STD = np.asarray(_STD, np.float32)


def denormalize(img: np.ndarray) -> np.ndarray:
    """[.., 3, H, W] CLIP-normalized -> [.., H, W, 3] uint8."""
    x = np.moveaxis(np.asarray(img, np.float32), -3, -1)
    x = (x * CLIP_STD + CLIP_MEAN) * 255.0
    return np.round(np.clip(x, 0, 255)).astype(np.uint8)


def add_border(frames: np.ndarray, pad: int = 4, value: int = 0) -> np.ndarray:
    """[T, H, W, 3] -> [T, H+2p, W+2p, 3] black border (method.py:76-79)."""
    T, H, W, C = frames.shape
    out = np.full((T, H + 2 * pad, W + 2 * pad, C), value, frames.dtype)
    out[:, pad:-pad, pad:-pad] = frames
    return out


def events_to_video(events: np.ndarray, quantize_args: Dict) -> np.ndarray:
    """Raw events -> bordered [T, H', W', 3] uint8 video frames."""
    from ..ops.numpy_ref import events_to_frames_np

    q = dict(quantize_args)
    q.pop("max_imgs", None)
    q.pop("split_method", None)
    q.pop("convert_method", None)
    q["background_mask"] = True  # method.py:110 forces white background
    N = q.pop("N")
    shape = q.pop("shape")
    frames = events_to_frames_np(events, N, shape, **q)
    return add_border(frames)


def save_gif(frames: np.ndarray, path: str, fps: int = 2) -> None:
    """[T, H, W, 3] uint8 -> animated GIF (PIL; wandb.Video stand-in)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def sample_indices(n_samples: int, dataset_len: int) -> np.ndarray:
    """Uniform sample positions (reference _get_sample_idx, method.py:47-52)."""
    N = n_samples
    if dataset_len % N != 0:
        N = N - 1
    N = max(N, 1)
    return np.arange(0, dataset_len, max(dataset_len // N, 1))


def visualize_samples(
    val_set,
    probs_fn,
    out_dir: str,
    n_samples: int = 5,
    classes: Optional[Sequence[str]] = None,
    inputs_fn=None,
) -> List[Dict]:
    """Render n_samples val items with GT + top-3 captions.

    probs_fn(windows [1, V, N, 3] int16 packed x/y/p, valid [1, V], both
    numpy) -> probs [1, n_cls] (anything numpy converts). inputs_fn
    (optional): same args -> CLIP-normalized imgs [1, V, 3, S, S]; when
    given, the model-input frames are also saved (the reference's second
    wandb video, method.py:139-142).
    """
    classes = classes if classes is not None else val_set.classes
    os.makedirs(out_dir, exist_ok=True)
    records = []
    keep = val_set.keep_events
    val_set.keep_events = True
    try:
        for i, idx in enumerate(sample_indices(n_samples, len(val_set))):
            item = val_set[int(idx)]
            probs = np.asarray(
                probs_fn(item["windows"][None], item["valid_mask"][None]))[0]
            if inputs_fn is not None:
                imgs = np.asarray(inputs_fn(item["windows"][None],
                                            item["valid_mask"][None]))[0]
                frames = denormalize(imgs[item["valid_mask"]])
                if len(frames):
                    save_gif(add_border(frames),
                             os.path.join(out_dir, f"video_{i}.gif"))
            top = np.argsort(-probs)[:3]
            caption = {
                "gt": classes[item["label"]],
                "top3": [{"cls": classes[int(t)], "prob": float(probs[t])}
                         for t in top],
            }
            q = dict(val_set.raster_args)
            q["N"] = q.pop("window")
            q["shape"] = (q.pop("height"), q.pop("width"))
            video = events_to_video(item["events"], q)
            save_gif(video, os.path.join(out_dir, f"raw_events_{i}.gif"))
            records.append(caption)
    finally:
        val_set.keep_events = keep
    with open(os.path.join(out_dir, "captions.json"), "w") as f:
        json.dump(records, f, indent=2)
    return records
