"""Convert an OpenAI CLIP checkpoint (.pt) to the framework's npz format.

Port of scripts/convert_clip.py, with its arguments, output and exit
codes:

    python -m eventclip_tpu_torch.cli.convert_clip ViT-L-14.pt clip.npz

The .pt may be a torchscript archive (as OpenAI distributes it) or a plain
state dict. The npz holds the JAX package's layer-stacked tree, keyed by
'/'-joined tree paths (models/clip/convert.py), so both packages load it:
pass it to cli.train / cli.test via --clip_ckpt (or the CLIP_CKPT env var).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        sys.exit(1)
    src, dst = argv

    from ..engine.checkpoint import save_checkpoint
    from ..models.clip.convert import flatten_tree, load_clip_checkpoint

    params, cfg = load_clip_checkpoint(src)
    save_checkpoint(dst, flatten_tree(params), extra={"arch": cfg.name})
    size = os.path.getsize(dst) / 1e6
    print(f"{cfg.name}: wrote {dst} ({size:.1f} MB)")
    print(f"vision: {cfg.vision}")
    print(f"text:   {cfg.text}")


if __name__ == "__main__":
    main()
