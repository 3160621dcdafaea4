"""A checkout root in a temporary directory whose cells run the benchmark's
own traffic mixes and metrics on a tiny configuration (ring 128), so that
the harness runs end to end on the CPU in seconds."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TINY = {
    "protocol": "BatchedFHE", "server_set_size": 512, "client_set_size": 24,
    "bit_size": 32, "ring_dim": 128, "num_limbs": 10,
    "each_simple_table_size": 64, "each_cuckoo_table_size": 12,
    "max_items_per_position": 4, "n_simple_hash_functions": 2,
    "n_cuckoo_hash_functions": 2,
}
# small enough for a CPU run: 4 sets in the pool, short warm-up and trace
SMALL_TRAFFIC = {"traffic.pool": 4, "traffic.warmup_exchanges": 1,
                 "traffic.trace_after": 1, "traffic.trace_exchanges": 2}


# the multi-query mix, kept for a later cell, driven under the real metrics
LATER_CELLS = ["bfv_s2p20_c2048.split16", "bgv_s2p20_c2048.split16"]


def make_root(tmp: str) -> str:
    """A root holding BENCHMARK.json with the real cells' metrics and mixes,
    and cells of LATER_CELLS, their configurations replaced by tiny ones of
    the same scheme."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in LATER_CELLS:
        config, traffic = name.split(".")
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and m["name"] != "online_p95_ms":
                m["workloads"].append(name)
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(tmp, "psi_bench", sub))
    os.makedirs(os.path.join(tmp, "psi_bench", "configs"))
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            real = json.load(f)
        tiny = {**real, **TINY, "name": c["name"]}
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(tiny, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
