"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
"workloads"; the harness finds its files by name (see README.md):
portbench/configs/<config>.json, portbench/traffic/<traffic>.json and
portbench/metrics/<metric>.py (a metric's reader; a name with a suffix,
such as "device_idle_pct.bulk", falls back to the reader of the part
before the first dot).

Set-up builds one `GpuCodec` of the configuration, makes the inputs from
the seed and warms up every shape the traffic uses; then the window's
clients drive `codec.compress(data, checksum=...)` for --seconds in a
closed loop (loops.py). With --trace 0 the result carries the cell's end-to-end
metrics; with --trace 1 the window runs under torch.profiler with the
harness's spans on the codec, and the result carries the per-layer
metrics, the device's busy time and a breakdown. Either way the frames
are then judged by the plain reference (check.py), whose numbers are
printed beside their limits as the last lines of standard error and
under "checks", the last key of the result line, which is the last line
of standard output. Without a CUDA device, or with fewer than the cell
asks for, it exits with 2 and prints no result; so it does if a JAX
module (or the JAX package) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level modules the port must not load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "qat_zstd_plugin_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict          # BENCHMARK.json
    entry: dict         # its "workloads" entry
    config: dict
    traffic: dict

    def metrics(self, section: str) -> list[dict]:
        """The metrics of BENCHMARK.json's `section` this cell reports."""
        return [m for m in self.spec[section]
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}: one of "
                         f"{sorted(entries)}")
    entry = entries[name]
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(name, spec, entry, _json(os.path.join(root, config["file"])),
                _json(os.path.join(root, "portbench", "traffic",
                                   f"{entry['traffic']}.json")))


def reader(metric: str):
    """The `read(run)` function of a metric, found by name."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: Cell
    window: object           # loops.Window
    setup_s: float
    host_before: tuple       # BlockStats (total_seconds, input_bytes)
    host_after: tuple
    kind: str                # the device's name
    rec: object = None       # trace.Recorder in the traced run
    device: dict | None = None  # trace.device_activity's summary


def _host(codec) -> tuple[float, int]:
    return codec.stats.total_seconds, codec.stats.input_bytes


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda") -> tuple[dict, list[str]]:
    """One run; returns (the result line's object, notes for stderr)."""
    import torch

    from . import check
    from .traffic import make_inputs
    cfg = cell.config
    codec, compress = make_codec(cfg, device)
    inputs = make_inputs(cell.traffic, seed)
    warm_up(compress, inputs)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    rec = prof = None
    align_ns = 0
    before = _host(codec)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from .trace import Recorder, mark
        rec = Recorder()
        rec.instrument(codec)
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if device == "cuda"
                                   else ProfilerActivity.CPU])
        prof.__enter__()
        if device == "cuda":
            align_ns = mark(device)
    window = drive(compress, inputs, seconds)
    if trace:
        if device == "cuda":
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    after = _host(codec)
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    r = Run(cell, window, setup_s, before, after, kind, rec)
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": False, "attempted": len(window.calls), "failed": 0,
           "metrics": {}, "device": dev}
    if trace and device == "cuda":
        from .trace import device_activity
        r.device = device_activity(prof, rec, align_ns, window.start,
                                   window.start + window.seconds)
        if r.device:
            dev["busy_s"] = r.device["busy_s"]
            dev["window_s"] = r.device["window_s"]
            out["breakdown"] = {k: [list(x) for x in r.device[k]]
                                for k in ("device_ops", "idle_gaps")}
    del prof
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = reader(m["name"])(r)
        if value is not None:
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    took = sorted(c.end - c.start for c in window.calls if c.end is not None)
    if took:
        print(f"portbench: {len(took)} calls in {window.seconds:.3f} s, "
              f"each {took[0]:.3f} / {took[len(took) // 2]:.3f} / "
              f"{took[-1]:.3f} s (min / median / max)", file=sys.stderr)
    t0 = time.perf_counter()
    numbers, notes = check.judge(window.calls, cfg, cell.traffic["check"],
                                 seed)
    print(f"portbench: the reference took {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    out["failed"] = numbers["missing"]
    out["correct"] = check.correct(numbers)
    out["checks"] = check.compared(numbers)
    return out, notes


def make_codec(cfg: dict, device: str):
    """The configuration's codec, and the call the window makes."""
    from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec
    codec = GpuCodec(level=cfg["level"], batch=cfg["batch"],
                     block_size=cfg["block_size"], device=device,
                     device_entropy=cfg["device_entropy"])

    def compress(data):
        return codec.compress(data, checksum=cfg["checksum"])
    return codec, compress


def warm_up(compress, inputs) -> None:
    """Every shape the window will use, as many at once as it will: the
    largest input and then the smallest on every client at once (a device
    batch is padded to one shape whatever its rows, a short tail block
    takes the host matcher; the device's memory pool grows to what the
    clients hold together)."""
    from . import loops
    by_size = sorted(inputs.objects, key=len)
    for data in {len(d): d for d in (by_size[-1], by_size[0])}.values():
        loops.together(compress, [data] * inputs.workers)


def drive(compress, inputs, seconds: float):
    from . import loops
    return loops.closed(compress, inputs.objects, inputs.workers, seconds)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out, notes = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 2
    for note in notes[:20]:
        print(f"portbench: fault: {note}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"portbench: check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
