"""Training CLI of the port: a dataset tree and CLIP weights -> checkpoints.

Port of the root train.py (reference train.py:98-149), run on the card
unless --cpu is given:

    python -m eventclip_tpu_torch.cli.train \
        --params configs/fsclip/joint_adapter/joint_fsclip_ncaltech_params.py \
        --clip_ckpt ViT-L-14.pt --data_root data/N-Caltech101 \
        [--num_shots K] [--N n(thousands)] [--weight ckpt] [--max_epochs E] \
        [--fp32] [--accum A] [--ckpt_base checkpoint]

Checkpoints go to `<ckpt_base>/<config name>[-N_<n>][-<K>shot]/models/`
(best.npz, model_<step>.npz, resume.pt) with a metrics.jsonl beside them.
--clip_ckpt takes an OpenAI `.pt` or a converted `.npz`; without it only
debug towers or --smoke (random towers) run. `--profile N` traces N train
steps (torch.profiler) under `<ckpt dir>/profile/`.

Data parallel: every process runs this same command, one card each, and
joins one run through the coordination env, the JAX package's triple
(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or
torchrun's:

    torchrun --nproc_per_node=2 -m eventclip_tpu_torch.cli.train ...

Rank r runs on cuda:LOCAL_RANK (default 0) and loads its shard of every
global batch; rank 0 alone writes checkpoints and metrics. `--n_model M`
splits the towers' blocks over groups of M ranks (Megatron tensor
parallelism; the world must be a multiple of M, and the ranks of a group
load the same rows), and `--zero1` keeps each data rank's slice of the
Adam moments only (parallel/sharding.py):

    torchrun --nproc_per_node=4 -m eventclip_tpu_torch.cli.train \
        --params ... --n_model 2 --zero1
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..data import build_dataset
from ..engine.trainer import EventCLIPTrainer
from ..parallel.distributed import initialize_distributed, process_index
from ..utils.config import load_params


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="EventCLIP port train")
    parser.add_argument("--params", type=str, required=True)
    parser.add_argument("--num_shots", type=int, default=-1)
    parser.add_argument("--N", type=int, default=-1,
                        help="events per window, in thousands")
    parser.add_argument("--weight", type=str, default="", help="load weight")
    parser.add_argument("--data_root", type=str, default="")
    parser.add_argument("--clip_ckpt", type=str,
                        default=os.environ.get("CLIP_CKPT", ""))
    parser.add_argument("--n_model", type=int, default=1,
                        help="model-parallel (tensor-parallel) group size; "
                        "the world must be a multiple of it")
    parser.add_argument("--max_epochs", type=int, default=-1)
    parser.add_argument("--ckpt_base", type=str, default="checkpoint")
    parser.add_argument("--san_check_val_step", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (debug/smoke runs)")
    parser.add_argument("--smoke", action="store_true",
                        help="allow RANDOM CLIP weights (pipeline/throughput "
                        "testing; accuracies will be garbage)")
    parser.add_argument("--profile", type=int, default=0,
                        help="trace N train steps (torch.profiler) under "
                        "<ckpt dir>/profile/")
    parser.add_argument("--fp32", action="store_true",
                        help="run activations in f32 instead of bf16")
    parser.add_argument("--accum", type=int, default=0,
                        help="gradient-accumulation microbatches per "
                        "optimizer step (keeps the config's global batch)")
    parser.add_argument("--zero1", action="store_true",
                        help="shard the persistent optimizer moments over "
                        "the data axis (ZeRO stage 1) instead of "
                        "replicating them per data-parallel replica")
    return parser.parse_args(argv)


def load_and_override(args):
    """The train CLI's param mutations (reference train.py:113-139);
    returns (params, experiment name)."""
    exp_name = os.path.basename(
        args.params[:-3] if args.params.endswith(".py") else args.params)
    params = load_params(args.params)

    assert params.model != "ZSCLIP", (
        "ZSCLIP has no trainable leaves; use cli.test directly")
    if args.N > 0:
        params.quantize_args["N"] = int(args.N * 1000)
        exp_name += f"-N_{args.N}"
    if args.num_shots > 0:
        params.num_shots = args.num_shots
        exp_name += f"-{args.num_shots}shot"
        # tiny few-shot datasets cannot fill the global batch
        # (train.py:129-139)
        if params.dataset == "n_cars":
            params.train_batch_size = min(args.num_shots * 2,
                                          params.train_batch_size)
        if params.dataset == "n_imagenet_mini":
            params.train_batch_size = min(args.num_shots * 100,
                                          params.train_batch_size)
    if args.data_root:
        params.data_root = args.data_root
    if args.max_epochs > 0:
        params.max_epochs = args.max_epochs
    if args.profile > 0:
        params.profile_steps = args.profile
    if args.fp32:
        params.bf16 = False
    if args.accum > 0:
        params.accum_steps = args.accum
    if args.zero1:
        params.zero1 = True
    return params, exp_name


def main(argv: Optional[List[str]] = None) -> EventCLIPTrainer:
    """Run the CLI; returns the trainer after `fit`."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else \
        f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    if not args.cpu:
        import torch

        torch.cuda.set_device(device)
    # a multi-process launch joins one data-parallel run before the
    # datasets are built (root train.py:119-128)
    initialize_distributed(device=device)
    params, exp_name = load_and_override(args)

    train_set, val_set = build_dataset(params)
    if process_index() == 0:
        print(f"dataset={params.dataset} classes={len(train_set.classes)} "
              f"train={len(train_set)} val={len(val_set)} "
              f"views(train/val)={train_set.max_imgs}/{val_set.max_imgs}")

    ckpt_dir = os.path.join(args.ckpt_base, exp_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    trainer = EventCLIPTrainer(
        params, train_set, val_set, ckpt_dir=ckpt_dir,
        clip_ckpt=args.clip_ckpt or None,
        log_file=os.path.join(ckpt_dir, "metrics.jsonl"),
        seed=args.seed, smoke=args.smoke, device=device,
        n_model=args.n_model)
    trainer.fit(resume_from=args.weight,
                san_check_val_step=args.san_check_val_step)
    return trainer


if __name__ == "__main__":
    main()
