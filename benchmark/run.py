"""Run one cell of BENCHMARK.json on one card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m benchmark.run ...                     (the same, from the checkout root)

Set-up (counted in `setup_s`, from the start of this process to the first
timed step): import torch and the program, make the cell's scene (the
configuration's `scene` generator) and the mix's inputs (its `inputs`
generator) on the card from the seed, build the mix's `steps` (the kernels are
built on a checkout's first run), and run each of the steps' inputs once. The
window then runs closed-loop steps, each ending in a synchronise, for
`--seconds`. With `--trace 1` the steps after
the first run under `torch.profiler` for the mix's `trace_steps`, and the line
carries the per-layer metrics instead of the end-to-end ones.

After the window, `memory_peak_bytes` is read, the program's state is freed,
and a sample of the window's outputs, drawn from the seed, is compared with the
plain reference by the mix's `check` (`benchmark/checks.py`,
`benchmark/reference/`): each number compared is printed beside its limit on
standard error and under "checks", the last key of the line. No card, too few cards, or jax / the JAX package loaded in this process
exits non-zero with no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __package__ in (None, ""):  # run as a script: import from the checkout's root
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import entry, profiling  # noqa: E402
from benchmark.reference import compare  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_bvh")  # top-level module names, compared whole
HERE = os.path.join(ROOT, "benchmark")


def load_json(path: str):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def _load(folder: str, name: str):
    """benchmark/<folder>/<name>.py as a module."""
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> dict:
    """A cell of BENCHMARK.json with its configuration, traffic mix and the
    metrics it reports, all found by name."""
    spec = load_json("BENCHMARK.json")
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
    return {"workload": w, "config": load_json(cfg["file"]),
            "traffic": load_json(os.path.join("benchmark", "traffic", w["traffic"] + ".json")),
            "end_to_end": e2e, "per_layer": layer, "chips": w["chips"]}


def peaks(device_name: str) -> dict:
    table = load_json(os.path.join("benchmark", "peaks.json"))
    return table.get(device_name, {})


class Window:
    """What the timed window did: step latencies, its length, the work done."""

    def __init__(self, latencies, seconds, work_per_step, setup_s):
        self.latencies_s = latencies
        self.seconds = seconds
        self.steps = len(latencies)
        self.work = self.steps * work_per_step
        self.setup_s = setup_s


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", overrides=None,
        steps_hook=None, t_start: float | None = None) -> dict:
    """One run of a cell; returns the result line as a dict. `overrides`
    updates the configuration and the mix (tests run tiny cells on the CPU);
    `steps_hook` wraps the program's steps (the tests' faults, the control)."""
    t_start = T_START if t_start is None else t_start
    c = cell(workload)
    config, traffic = dict(c["config"]), dict(c["traffic"])
    for part, upd in (overrides or {}).items():
        {"config": config, "traffic": traffic}[part].update(upd)
    sc = entry(config["scene"])(config, traffic, seed, device)
    make_inputs = entry(traffic.get("inputs"))
    inputs = make_inputs(config, traffic, sc, seed, device) if make_inputs else None
    steps = entry(traffic["steps"])(config, traffic, sc, inputs, device)
    if steps_hook is not None:
        steps = steps_hook(steps, sc, inputs, config, traffic)
    for i in range(steps.inputs):  # every input the window uses, once
        steps(i)
    _sync(device)

    readers = {m["name"]: _load("metrics", m["name"]) for m in c["per_layer"]} if trace else {}
    store = {name: [] for name in readers}
    n_traced = traffic["trace_steps"]
    keep = traffic["check"]["steps"]
    pick = random.Random(seed * 2654435761 + 1)
    sample, latencies = [], []
    prof, trace_path = None, None
    span = f"{profiling.SPAN_PREFIX}{c['workload']['traffic']}"
    setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    i = 0
    while True:
        if trace and i == 1:
            fd, trace_path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=n_traced, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(trace_path))
            prof.start()
        a = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function(span):
                idx, out = steps(i)
                _sync(device)
        else:
            idx, out = steps(i)
            _sync(device)
        b = time.perf_counter()
        latencies.append(b - a)
        if prof is not None:
            if 2 <= i <= n_traced + 1:  # the active steps
                for name, mod in readers.items():
                    if hasattr(mod, "collect"):
                        mod.collect(store[name], out)
            prof.step()
            if i == n_traced + 1:
                prof.stop()
                prof = None
        if len(sample) < keep:  # a reservoir of the window's outputs
            sample.append((i, idx, out))
        else:
            j = pick.randrange(i + 1)
            if j < keep:
                sample[j] = (i, idx, out)
        del out
        i += 1
        if b - w0 >= seconds and (not trace or i > n_traced + 1):
            break
    window = Window(latencies, b - w0, steps.work_per_step, setup_s)

    is_cuda = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if is_cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if is_cuda else 0}
    metrics, breakdown = {}, None
    if trace:
        tr = profiling.Trace(trace_path)
        os.remove(trace_path)
        sizes = dict(sc.sizes, **getattr(inputs, "sizes", {}))
        ctx = profiling.Context(tr, n_traced, sizes, os.path.join(HERE, "kernels"),
                                peaks(dev_info["kind"]), store)
        for m in c["per_layer"]:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        for m in c["end_to_end"]:
            v = _load("end_to_end", m["name"]).read(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    del steps
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    per = entry(traffic["check"]["entry"])(sample, sc, inputs, config, traffic, seed)
    readings = dict(compare.worst(per), per_output=per)
    print(f"the check of {len(sample)} outputs took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    limits = traffic["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    failed = sum(1 for r in readings["per_output"] if any(r[k] > limits[k] for k in limits))
    result = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
              "attempted": window.steps, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
