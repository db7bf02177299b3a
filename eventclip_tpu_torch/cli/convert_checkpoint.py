"""Convert trained EventCLIP method checkpoints between torch and npz.

Port of scripts/convert_checkpoint.py, with its arguments, outputs and
exit codes.

Import (migrate FROM the reference: .pth in, npz out):

    python -m eventclip_tpu_torch.cli.convert_checkpoint best.pth best.npz

The input is a checkpoint the reference trainer saved
(``checkpoint/<exp>/models/{best.pth,model_<it>.pth}``): CLIP-free state
dicts holding the trained adapter / prompt-tuned text features / LoRA
deltas / fine-tuned visual tower. The output npz is the trainable-leaf
checkpoint both packages load: pass it to cli.test / serve via
``--weight`` with the SAME experiment config the reference run used.

Export (take weights trained here back to torch: npz in, .pth out):

    python -m eventclip_tpu_torch.cli.convert_checkpoint best.npz \\
        best.pth [clip_base]

Emits the reference's exact state-dict key space (wrapped under
'state_dict'), loadable by its ``model.load_weight``. FT checkpoints
(LoRA / partial fine-tune) also need ``clip_base``, the frozen CLIP tower
(a converted .npz or the original .pt), because the reference saves the
whole ``model.visual.*`` while these checkpoints keep only the trainable
leaves.

(For the base CLIP weights themselves, see cli/convert_clip.py.)
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np


def describe(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            describe(v, f"{prefix}{k}/")
        else:
            print(f"  {prefix}{k}  {np.shape(v)}")


def _read_npz(path):
    """The tree of an npz checkpoint, its '__extra__/' entries dropped."""
    from ..models.clip.convert_method import unflatten

    with np.load(path, allow_pickle=False) as z:
        return unflatten({k: z[k] for k in z.files
                          if not k.startswith("__extra__/")})


def _load_clip_visual(path):
    if path.endswith(".npz"):
        return _read_npz(path)["visual"]
    from ..models.clip.convert import load_clip_checkpoint

    return load_clip_checkpoint(path)[0]["visual"]


def _export(src, dst, clip_base):
    from ..models.clip.convert_method import save_method_checkpoint

    clip_visual = _load_clip_visual(clip_base) if clip_base else None
    save_method_checkpoint(dst, _read_npz(src), clip_visual=clip_visual)
    print(f"wrote {dst} ({os.path.getsize(dst) / 1e6:.1f} MB) in the "
          "reference's .pth key space")


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print(__doc__)
        sys.exit(1)
    src, dst = argv[0], argv[1]
    clip_base = argv[2] if len(argv) == 3 else ""

    if src.endswith(".npz"):  # export: npz -> torch .pth
        _export(src, dst, clip_base)
        return

    from ..engine.checkpoint import save_checkpoint
    from ..models.clip.convert import flatten_tree
    from ..models.clip.convert_method import load_method_checkpoint

    tree = load_method_checkpoint(src)
    save_checkpoint(dst, flatten_tree(tree))
    print(f"wrote {dst} ({os.path.getsize(dst) / 1e6:.1f} MB) holding:")
    describe(tree)


if __name__ == "__main__":
    main()
