"""A cell of the benchmark cut to a size the CPU runs in seconds: the
ViT-T/8@32 debug tower (the repo's debug configs' geometry) in float32,
requests of 4 short recordings. Used by the tests only."""

from __future__ import annotations

import copy
import os

from portbench import core

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)


def tiny_cell(name: str = "zs_ncaltech.batch32") -> core.Cell:
    bench = core.read_json(os.path.join(os.path.dirname(BENCH_DIR),
                                        "BENCHMARK.json"))
    cell = core.find_cell(bench, name, BENCH_DIR)
    cfg = copy.deepcopy(cell.config)
    cfg["arch"] = "ViT-T/8@32"
    cfg["params"]["clip_dict"]["arch"] = "ViT-T/8@32"
    cfg["params"]["bf16"] = False
    cfg["vision"] = {"image_size": 32, "patch_size": 8, "width": 64,
                     "layers": 2, "heads": 2, "mlp_width": 256,
                     "output_dim": 32}
    # sharp attention and small embeddings keep the 32-pixel frames'
    # answers apart (their spread reads about 1e-3, the gap 1e-8)
    cfg["init"] = dict(cfg["init"], proj=[0.0, 0.0025],
                       class_embedding=[0.0, 0.01],
                       positional_embedding=[0.0, 0.01])
    cfg["init"]["attn.in_proj_weight"] = [0.0, 0.4]
    for ln in ("ln_1.weight", "ln_2.weight"):
        cfg["init"][ln] = [1.0, 0.1]
    # the float32 program reads about 1e-4 of what bfloat16 costs here
    cfg["limits"] = {k: 0.01 for k in cfg["limits"]}
    tr = copy.deepcopy(cell.traffic)
    tr.update(batch=4, copies=2, events={"min": 20000, "max": 60000,
                                         "levels": 4},
              check={"streams": 6})
    cell.config, cell.traffic = cfg, tr
    return cell

