"""One run of one cell of the port's benchmark.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s>
                              --trace <0|1> [--device cuda|cpu]

Everything a cell is made of is found by name from ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the job's driver,
``jobs/<kind>.py``), its metrics (``metrics/<metric>.py``, each a
``read(ctx)``) and its plain reference (``reference/<config>.py``).

A run makes its inputs from the seed, runs its warm jobs (set-up), then
whole jobs back to back until ``--seconds`` have passed: the window ends
with the last job, so every job counted is whole. ``--trace 0`` reports the
cell's end-to-end metrics. ``--trace 1`` reports its per-layer metrics: it
runs that window, whose jobs the host-clock and counter metrics read, then
a second window of the same length under ``torch.profiler``, whose trace
and jobs the device-trace metrics read, so that the profiler's own host
work is in no host-clock reading. After the windows the program's state is
freed, the kept outputs (of both windows) are held against the reference,
and the last line of standard output is the result. A run needs as many
cards as the cell asks for; ``--device cpu`` (the tests) skips that look
and runs the same path on the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()


def keep_freed_memory() -> bool:
    """Have glibc's allocator keep freed host memory for the next job.

    A job's outputs land in new host arrays of some hundreds of MB, and
    glibc gives every such block a mapping of its own and unmaps it when it
    is freed, so each job touches fresh pages. Where touching a fresh page
    is costly and uneven (under a sandboxing kernel that traps every first
    touch), that cost, not the program, sets the rate and its spread.
    With no block mapped apart (``M_MMAP_MAX`` 0) and the heap's top never
    trimmed below 2 GiB (``M_TRIM_THRESHOLD``), a block freed by one job is
    reused by the next. Returns whether both options took."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
        no_maps = libc.mallopt(-4, 0)  # M_MMAP_MAX
        no_trim = libc.mallopt(-1, 2 ** 31 - 1)  # M_TRIM_THRESHOLD
        return bool(no_maps and no_trim)
    except (OSError, AttributeError):  # not glibc
        return False


HEAP_KEPT = keep_freed_memory()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"
BANNED = ("jax", "jaxlib", "flax", "kmer_hasher_tpu")


class RunError(Exception):
    """A run that prints no result: the exit code and the message."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def load_module(path: Path, package: str = "port_bench"):
    """A file of the benchmark as a module of ``package`` (names may hold
    dots, which an import by name would not take)."""
    name = f"{package}._{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench: Optional[dict] = None):
    """(benchmark, cell, configuration, traffic) for one workload name."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(2, f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return bench, cell, cfg, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer ones, else
    its end-to-end ones; a metric without ``workloads`` goes to every cell
    (end to end) or to every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def check_device(dev_name: str, chips: int):
    import torch

    if dev_name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RunError(2, "torch.cuda.is_available() is false: this cell "
                          "runs on a card")
    if torch.cuda.device_count() < chips:
        raise RunError(2, f"the cell asks for {chips} cards, "
                          f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def banned_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in BANNED)


def alloc_counts(dev) -> dict:
    """The caching allocator's counts of device allocations and frees."""
    import torch

    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: int(st.get(k, 0)) for k in (
        "num_device_alloc", "num_device_free", "num_alloc_retries",
        "num_sync_all_streams")}


def device_info(dev, chips: int, peak: Optional[int]) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak or 0)}


def card_line(dev) -> str:
    """The card's name and power limit (nvidia-smi), to stand beside the
    numbers."""
    import subprocess

    if dev.type != "cuda":
        return "cpu (host clock, no device)"
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run(args, bench: Optional[dict] = None, overrides: Optional[dict] = None
        ) -> dict:
    """One run; returns the result record (the caller prints it)."""
    # the port builds into kmer_hasher_tpu_torch/build/; kernels built by
    # Triton or torch's extension loader would cache here, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    bench, cell, cfg, traffic = load_cell(args.workload, bench)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    import torch

    from . import drivers

    dev = check_device(args.device, int(cell["chips"]))
    peaks = json.loads((HERE / "peaks.json").read_text())
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    drv = drivers.make(cfg, traffic, args.seed, dev)
    try:
        drv.setup()
        drivers.sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        mem0 = alloc_counts(dev)
        setup_s = time.perf_counter() - T_START
        card = card_line(dev)
        print(f"[run] {cell['name']} seed {args.seed}: set-up {setup_s:.3f} s "
              f"on {card}; freed host memory kept: {HEAP_KEPT}",
              file=sys.stderr, flush=True)
        jobs, attempted, failed, window_s, _ = window(
            drv, args.seconds, False, dev)
        trace_jobs, prof = None, None
        if args.trace and not failed:
            trace_jobs, n, f, _, prof = window(drv, args.seconds, True, dev,
                                               start=attempted)
            attempted, failed = attempted + n, failed + f
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        mem1 = alloc_counts(dev)
        print("[run] device allocator in the window: " + ", ".join(
            f"{k} {mem1[k] - mem0[k]}" for k in mem0), file=sys.stderr,
            flush=True)
        tr = None
        if prof is not None:
            from .trace import Trace

            tr = Trace(prof)
            del prof
        drv.release()
        t_check = time.perf_counter()
        checks = drv.check(load_module(HERE / "reference"
                                       / f"{cell['config']}.py",
                                       "port_bench.reference"))
        check_s = time.perf_counter() - t_check
    finally:
        drv.close()
    found = banned_modules()
    if found:
        raise RunError(3, "modules of JAX or of the JAX package are loaded: "
                       + ", ".join(found))
    ctx = {"workload": cell["name"], "config": cfg, "traffic": traffic,
           "setup_s": setup_s, "window_s": window_s, "jobs": jobs,
           "trace_jobs": trace_jobs, "peak_bytes": peak, "trace": tr,
           "peaks": peaks.get(kind, {})}
    metrics = {}
    for m in cell_metrics(bench, cell, bool(args.trace)):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (failed == 0 and attempted > 0
               and all(c["value"] <= c["limit"] for c in checks))
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": device_info(dev, int(cell["chips"]), peak)}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    print(f"[run] {len(jobs)} jobs in the {window_s:.3f} s window "
          f"({attempted} attempted in all), {failed} failed; reference and "
          f"comparison {check_s:.3f} s; card {card}",
          file=sys.stderr, flush=True)
    walls = sorted(j["wall_s"] for j in jobs)
    if walls:
        print("[run] job seconds: min {:.4f} median {:.4f} max {:.4f}; in "
              "order: {}".format(walls[0], walls[len(walls) // 2], walls[-1],
                                 " ".join(f"{j['wall_s']:.3f}"
                                          for j in jobs[:200])),
              file=sys.stderr, flush=True)
    for c in checks:
        print(f"check {c['name']} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return out


def window(drv, seconds: float, trace: bool, dev, start: int = 0):
    """Whole jobs back to back until ``seconds`` have passed, numbered from
    ``start``. Returns the completed jobs' records, the attempted and
    failed counts, the window's host seconds and the profiler (or None)."""
    import torch

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    jobs, attempted, failed = [], 0, 0
    try:
        with torch.profiler.record_function("port_bench.window"):
            t0 = time.perf_counter()
            while attempted == 0 or time.perf_counter() - t0 < seconds:
                i = start + attempted
                attempted += 1
                try:
                    with torch.profiler.record_function("port_bench.job"):
                        rec, out = drv.job(i)
                except Exception:  # a failed job ends the window
                    failed += 1
                    traceback.print_exc()
                    break
                jobs.append(rec)
                drv.offer(i, out)
            window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return jobs, attempted, failed, window_s, prof


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None, overrides: Optional[dict] = None,
         bench: Optional[dict] = None) -> int:
    """The command line; the tests may give ``overrides``, keys of the
    configuration and the traffic to replace (a cell at a tiny size), and
    ``bench`` in place of ``BENCHMARK.json``."""
    args = parse(argv)
    try:
        out = run(args, bench=bench, overrides=overrides)
    except RunError as e:
        print(f"[run] no result: {e}", file=sys.stderr, flush=True)
        return e.code
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
