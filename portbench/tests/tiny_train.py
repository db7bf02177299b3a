"""The training cell cut to a size the CPU runs in seconds: the ViT-T/8@32
debug tower in float32, 120 x 160 frames of 5,000-event windows, batches
of 4 recordings from 12 items. Used by the tests only."""

from __future__ import annotations

import copy
import os

from portbench import core

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)


def tiny_train_cell(name: str = "ft_nin.train_b128") -> core.Cell:
    bench = core.read_json(os.path.join(os.path.dirname(BENCH_DIR),
                                        "BENCHMARK.json"))
    cell = core.find_cell(bench, name, BENCH_DIR)
    cfg = copy.deepcopy(cell.config)
    cfg["arch"] = "ViT-T/8@32"
    cfg["params"]["clip_dict"]["arch"] = "ViT-T/8@32"
    cfg["params"]["bf16"] = False
    cfg["params"]["train_batch_size"] = 4
    cfg["params"]["num_workers"] = 2
    cfg["params"]["quantize_args"]["N"] = 5000
    cfg["vision"] = {"image_size": 32, "patch_size": 8, "width": 64,
                     "layers": 2, "heads": 2, "mlp_width": 256,
                     "output_dim": 32}
    cfg["dataset"] = dict(cfg["dataset"], resolution=[120, 160],
                          max_n=10000)
    cfg["n_classes"] = 10
    # the float32 program against the float32 reference
    cfg["limits"] = {k: 1e-3 for k in cfg["limits"]}
    tr = copy.deepcopy(cell.traffic)
    tr.update(items=12, copies=2, events={"min": 10500, "max": 14000,
                                          "levels": 3},
              check={"steps": 3, "block": 2})
    cell.config, cell.traffic = cfg, tr
    return cell
