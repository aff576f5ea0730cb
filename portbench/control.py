"""The control of a cell's correctness check: a lower precision put in the
program's place, which the check has to fail.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--cpu]

The configuration's ``control`` names it: ``{"kind": "reference",
"precision": "bf16"}`` is the reference with every aggregated cost rounded
to bfloat16; ``{"kind": "program", "model": {...}}`` is the program's own
lower-precision path (the model's settings with those fields replaced),
driven through the cell's served entry. For each seed it takes the
stream's first ``check_calls`` calls at the cell's shape (``--cpu``: the
rehearsal shape, the kernels' plain versions), compares the control's
outputs with the f32 reference's as the check does, and prints one JSON
line of readings. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def readings(workload: str, seeds, device) -> list:
    """One reading a seed: the check's numbers for the control."""
    import torch

    from portbench import check, run, serve, traffic as traffic_mod

    spec = run.resolve(workload)
    config, traffic = spec["config"], spec["traffic"]
    control = config["control"]
    shape = config["shape"] if device.type == "cuda" else config["rehearsal_shape"]
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    entry = None
    if control["kind"] == "program":
        entry = serve.entry_of(run.build_model(_merge(config["model"], control["model"])),
                               traffic)
    out = []
    for seed in seeds:
        pool = traffic_mod.make_pool(traffic, shape, seed)
        got, want = [], []
        for c in range(traffic["check_calls"]):
            items = list(range(c * traffic["chunk"], (c + 1) * traffic["chunk"]))
            want += run.recompute(ref, config, traffic, pool, items, device)
            if entry is None:
                got += run.recompute(ref, config, traffic, pool, items, device,
                                     precision=control["precision"])
            else:
                lefts, rights = serve.host_frames(pool, items)
                ls = torch.as_tensor(lefts, device=device).to(torch.float32)
                rs = torch.as_tensor(rights, device=device).to(torch.float32)
                got += [(d.cpu().numpy(), v.cpu().numpy()) for d, v in entry(ls, rs)]
        numbers = check.mismatches(got, want)
        out.append({"seed": seed, **numbers, "frames": len(got),
                    "correct": check.verdict(numbers)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--cpu", action="store_true", help="the rehearsal shape on the CPU")
    args = p.parse_args(argv)
    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("no CUDA device (--cpu runs the rehearsal shape)", file=sys.stderr)
        return 2
    rows = readings(args.workload, args.seeds, device)
    print(json.dumps({"workload": args.workload, "device": str(device), "readings": rows}))
    return 0 if not any(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
