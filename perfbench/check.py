"""The comparison that decides ``correct``.

The reference recomputes, from the inputs the benchmark made and the
weights it made, what the timed path had to produce for each row: the
infeed (resize or 4:2:0 reconstruction, the half-to-even round) and the
network, in float32 with TF32 off, on the card in blocks of rows. The
number compared is the worst row's relative error of the program's
outputs, ``|got - ref| / |ref|`` (Euclidean norms of the row), over every
row the window produced: every row of every pass. A missing or
non-finite row reads as infinite; a row in another row's place reads as
the distance between the two rows' features (the seeded images differ
in mean colour, so that distance lies far above the limit).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict

import numpy as np
import torch

from perfbench.reference import infeed

BLOCK = 128  # reference rows per call


@contextlib.contextmanager
def tf32_off():
    """float32 products in float32, for the reference only."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_outputs(cell, state, rows: np.ndarray, device,
                      quant=None) -> np.ndarray:
    """The reference's outputs [N, width] for the host rows ``rows`` as
    the program received them; ``quant`` computes the network in a lower
    precision (the control)."""
    ref = cell.reference()
    src = {"format": cell.mix["format"], "hw": cell.mix["src_hw"]}
    out_hw = tuple(cell.config["input_hw"])
    outs = []
    with torch.inference_mode(), tf32_off():
        for i in range(0, len(rows), BLOCK):
            x = torch.from_numpy(rows[i:i + BLOCK]).to(device)
            y = ref.forward(state, infeed.model_input(x, src, out_hw),
                            quant=quant)
            outs.append(y.float().cpu().numpy())
    return np.concatenate(outs)


def row_errors(got, ref: np.ndarray) -> np.ndarray:
    """Per row ``|got - ref| / |ref|``; inf for every row when the shape
    is wrong, and for a row with a non-finite value."""
    got = np.asarray(got, dtype=np.float64)
    if got.shape != ref.shape:
        return np.full(len(ref), np.inf)
    ref = ref.astype(np.float64)
    err = np.linalg.norm(got - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-30)
    err[~np.isfinite(got).all(axis=1)] = np.inf
    return err


def judge(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, checks): each number against its limit; no number at
    all is not correct."""
    checks, correct = {}, bool(numbers)
    for name, value in numbers.items():
        limit = float(limits[name]["limit"])
        ok = bool(np.isfinite(value) and value <= limit)
        correct = correct and ok
        checks[name] = {"value": float(value) if np.isfinite(value)
                        else 1e308, "limit": limit}
    return correct, checks


def report(checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit on standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
