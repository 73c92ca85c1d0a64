"""The readings a cell's limit is set from, at the cell's own size.

The controls are the reference put in the program's place and computed
one precision below the configuration's bfloat16: float8 e4m3 with a
scale per tensor on the network's products only (``fp8_operands``), and on
every bfloat16 value of the network (``fp8_values``); see
``reference/layers.py``. Each is judged by the number a run compares,
against the float32 reference, over every row a pass of the cell
produces. With ``--program`` the program's own reading comes beside
them: the cell's set-up as a run does it (seeded weights through the
program's weight cache, the frame, the transformer, one warm pass),
then one more pass of the timed entry, compared as a run compares it.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 [--program]

prints one JSON line per seed. Every control has to read above the
cell's limit on every seed, and the program below it. Reading many seeds
in one process pays the card's start-up once.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, device) -> dict:
    """Each control's worst-row relative error on ``seed``'s rows."""
    from perfbench import check
    from perfbench.reference.layers import CONTROLS
    from perfbench.weights import for_cell

    rows = cell.driver().rows(
        types.SimpleNamespace(cell=cell, seed=seed, device=device))
    state = for_cell(cell, seed, device)
    ref = check.reference_outputs(cell, state, rows, device)
    return {name: float(check.row_errors(
        check.reference_outputs(cell, state, rows, device, quant=q),
        ref).max()) for name, q in CONTROLS.items()}


def program_reading(cell, seed: int, device) -> float:
    """The program's number over one pass of the cell's timed entry."""
    from perfbench import passes
    from perfbench.run import Context
    tmp = tempfile.mkdtemp(prefix="perfbench-control-")
    try:
        ctx = Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=device, tmp=tmp)
        driver = cell.driver()
        st = driver.setup(ctx)
        out = st.planned.collect()
        m = passes.Measured(attempted=len(st.rows), failed=0, metrics={},
                            outputs=[out[st.out_col]])
        return driver.compare(ctx, st, m)["out_rel_err_max"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, device=None, manifest=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true",
                   help="also read the program on each seed")
    args = p.parse_args(argv)
    import torch
    from perfbench import harness
    cell = harness.resolve(args.workload, manifest)
    device = torch.device(device or "cuda")
    limit = cell.limits["numbers"]["out_rel_err_max"]["limit"]
    out = []
    for seed in args.seeds:
        line = {"workload": cell.name, "seed": seed, "limit": limit}
        if args.program:
            line["program"] = program_reading(cell, seed, device)
        line.update(readings(cell, seed, device))
        out.append(line)
        print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
