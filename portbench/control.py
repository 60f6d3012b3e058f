#!/usr/bin/env python3
"""The control of a cell's comparison, and the reference's time per GOP.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's pool made as a run makes it, every pool GOP
encoded by the reference (float64 transform products: the spec's exact
integer transform) and by the control, the same reference with its
transform products in bfloat16, the tensor-core shortcut that gives up
the exactness the configuration states. The control's packets and SSEs
stand in for the program's and are judged by run.py's comparison as the
program's are: one JSON line per seed with `correct`, the numbers
compared beside their limits and the seconds the reference took per
GOP. The benchmark's own runs do not run it; the limits in PERF.md were
set from its readings on the card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(workload: str, seed: int, *, device: str = "cuda",
             overrides=None) -> dict:
    """The control's verdict and its numbers compared, against the
    reference, on the cell's pool under `seed`: its packets in a stream
    laid out as the mux writes it, judged by run.compare and run.passes
    as a run judges the program's. `overrides` as in run.run_cell."""
    import importlib

    import torch

    sys.path.insert(0, ROOT)
    from portbench import content, run

    _, _, config, mix = run.cell_spec(workload)
    enc = dict(config["encoder"], **(overrides or {}).get("encoder", {}))
    mix = dict(mix, **(overrides or {}).get("mix", {}))
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    pool = content.make_pool(mix, enc, seed, torch.device(device))
    g_n, t_len = mix["gop_batch"], enc["gop_n"]
    header = ref.stream_header(enc, 0)
    parts, gops, want = [header], [], {}
    ref_s = 0.0
    for b in range(mix["pool_batches"]):
        gop = dict(b=b, sse=[])
        first = len(parts)
        for g in range(g_n):
            planes = content.pool_gop(pool, b, g)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            want[b, g] = ref.encode_gop(enc, *planes)
            ref_s += time.perf_counter() - t0
            packets, sse = ref.encode_gop(enc, *planes,
                                          transform=torch.bfloat16)
            parts += packets
            gop["sse"].append(sse)
        gop["parts"] = (first, len(parts))
        if g_n == 1:
            gop["sse"] = gop["sse"][0]
        gops.append(gop)
    check = run.compare(gops, parts, want, header, g_n, t_len)
    return {"workload": workload, "seed": seed, "gops": len(gops) * g_n,
            "correct": run.passes(check), "check": check,
            "reference_s_per_gop": ref_s / (len(gops) * g_n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
