"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Makes the cell's weights and inputs from the seed, builds the program
(``sparkdl_tpu_torch``) at the cell's shapes and warms it (all of it
counted as ``setup_s``, from this file's first line), measures for
``--seconds``, compares what the window produced with the plain
reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (and the traced run's
``breakdown``), then ``checks``, each compared number with its limit
(also the last lines of standard error).

It exits non-zero without a result when there is no CUDA card, fewer
than the cell asks for, or when a module of JAX or of the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@dataclasses.dataclass
class Context:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: str

    def mark(self, step: str) -> None:
        """Seconds since the process began, at the end of a set-up step,
        on standard error."""
        print(f"setup {step} {time.perf_counter() - T_START!r} s",
              file=sys.stderr)


def _environment():
    """The program at its defaults: no knob of a caller's environment."""
    for key in [k for k in os.environ if k.startswith("SPARKDL_TPU")]:
        del os.environ[key]


def flops_per_image(cell) -> float:
    """The configuration's reference forward on the meta device, counted
    by ``FlopCounterMode`` (a multiply-add is two)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    ref = cell.reference()
    h, w = cell.config["input_hw"]
    with torch.device("meta"):
        state = {k: torch.empty(s) for k, s in ref.param_shapes()}
        x = torch.empty((1, h, w, 3), dtype=torch.uint8)
        with FlopCounterMode(display=False) as counter:
            ref.forward(state, x)
    return float(counter.get_total_flops())


def main(argv=None, device=None, manifest=None) -> int:
    """``device``: None looks for the card the cell asks for; a test
    passes ``"cpu"`` to drive the rest of a run without one.
    ``manifest``: another ``BENCHMARK.json`` than the checkout's."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench import check, harness
    cell = harness.resolve(args.workload, manifest)
    _environment()
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); "
                  f"available: {torch.cuda.is_available()}, count "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device(device),
                      tmp=tmp)
        ctx.mark("imports")
        driver = cell.driver()
        st = driver.setup(ctx)
        setup_s = time.perf_counter() - T_START
        with harness.GcPauses() as pauses:
            measured = driver.measure(ctx, st)
        print(pauses.line(), file=sys.stderr)
        cuda = ctx.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        numbers = driver.compare(ctx, st, measured)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers = {name: numbers.get(name, float("inf"))
               for name in cell.limits["numbers"]}
    correct, checks = check.judge(numbers, cell.limits["numbers"])

    dev = {"platform": "gpu" if cuda else ctx.device.type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if ctx.trace:
        rec = measured.record
        rec.flops_per_image = flops_per_image(cell)
        rec.geometry = {"format": cell.mix["format"],
                        "src_hw": cell.mix["src_hw"],
                        "dst_hw": cell.config["input_hw"],
                        "batch": cell.mix["batch"]}
        metrics = harness.read_per_layer(cell, rec)
        dev.update(busy_s=rec.busy_s, window_s=rec.window_s)
        breakdown = measured.breakdown
    else:
        values = dict(measured.metrics, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    print(f"card: {harness.card_line() if cuda else None}",
          file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    check.report(checks)   # the last lines of standard error
    print(harness.result_line(correct, measured.attempted, measured.failed,
                              metrics, dev, checks, breakdown))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
