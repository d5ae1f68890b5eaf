"""Readings for the limits of `correct`: the program's and the control's,
over many seeds, in one process on one card.

    python -m zkbench.control --workload <cell> --seeds 1,2,3 --seconds 51 [--out chiprun_out/control]

The service starts once; each seed runs one window of the cell as a
benchmark run does. Every answer is judged twice by the reference: as
the program gave it (the lower readings), and with each request handed
the answer of the next one (the control: a valid proof and signature of
another statement, which breaks the guarantee that an answer proves the
request's own statement). Prints one JSON line per seed with both
readings and the end-to-end values.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .run import Session, cache_env, card_info, circuit_facts, counted, judge_all, judge_tasks, vk_check
from .spec import Spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zkbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="chiprun_out/control")
    args = ap.parse_args(argv)
    root = Path.cwd()
    os.environ.update(cache_env(root))
    import torch

    if not torch.cuda.is_available():
        print("zkbench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(root)
    cell = spec.cell(args.workload)
    card = card_info()
    session = Session(root, spec, cell)
    windows = [(int(s), session.measure(int(s), args.seconds)) for s in args.seeds.split(",")]
    vk, n, facts = session.vk, session.gen.key.n, circuit_facts(session.config)
    vk_bad = vk_check(vk, session.zkey)
    session.close()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    lines = []
    for seed, m in windows:
        program = counted(m, judge_all(*judge_tasks(m, vk, n, facts), os.cpu_count() or 1), vk_bad)
        control = counted(m, judge_all(*judge_tasks(m, vk, n, facts, shift=1), os.cpu_count() or 1), vk_bad)
        lines.append({"workload": cell["name"], "seed": seed, "card": card["kind"], "program": program,
                      "control": control, "end_to_end": m["end_to_end"], "attempted": m["attempted"],
                      "failed": m["failed"], "info": m["info"]})
        print(json.dumps(lines[-1]), flush=True)
    (out / f"{cell['name']}.jsonl").write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
