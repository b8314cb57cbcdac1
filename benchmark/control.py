"""The control of `correct`, and the readings the limits are set from.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 ... --seconds 2 [--control-seeds ...]

In one process, for each seed: a short window of the cell's own timed path at
the cell's own size, compared as a run compares it (the sound readings); then,
for each control seed, the same with the plain reference computed in bfloat16
put in the program's place (the control: the configuration states float32).
A mix names its control class (`"control"`), built as
`Control(steps, scene, inputs, config, traffic)` in place of the program's
steps. Prints one JSON line a run: {"seed", "side", "readings", "correct"},
and a last line with the largest sound reading and the smallest control
reading of each number. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import entry
from benchmark import run as bench
from benchmark.reference import traverse as ref_traverse

LOW = torch.bfloat16  # the precision below the configuration's float32


class ReferenceBuilds:
    """The configuration's reference builder in `dtype` in the program's place,
    cycling the scene's frames."""

    def __init__(self, steps, scene, inputs, config, traffic, dtype=LOW):
        self.inputs, self.work_per_step = steps.inputs, steps.work_per_step
        self.frames, self.config, self.dtype = scene.frames, config, dtype
        self.reference = entry(config["reference"])

    def __call__(self, i: int):
        f = i % self.inputs
        return f, self.reference(self.frames[f], self.config, self.dtype)


class ReferenceTraces:
    """The closest hits of the pose's rays in `dtype` through the reference's
    float32 tree of the mix's frame, in the program's place."""

    def __init__(self, steps, scene, inputs, config, traffic, dtype=LOW):
        self.inputs, self.work_per_step = steps.inputs, steps.work_per_step
        self.tris = scene.frames[traffic["frame"]]
        self.tree = entry(config["reference"])(self.tris, config)
        self.rays, self.dtype = inputs, dtype

    def __call__(self, i: int):
        p = i % self.inputs
        return p, ref_traverse.closest_hits(self.tree, self.tris, self.rays.origin[p],
                                            self.rays.direction[p], self.dtype)


def control_hook(steps, scene, inputs, config, traffic):
    return entry(traffic["control"])(steps, scene, inputs, config, traffic)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    sound, control = {}, {}
    for side, seeds, hook in (("program", args.seeds, None),
                              ("control", args.control_seeds, control_hook)):
        for seed in seeds:
            t0 = time.perf_counter()
            r = bench.run(args.workload, seed, args.seconds, False, steps_hook=hook,
                          t_start=t0)
            readings = {k: v["value"] for k, v in r["checks"].items()}
            print(json.dumps({"seed": seed, "side": side, "readings": readings,
                              "correct": r["correct"], "steps": r["attempted"],
                              "seconds": time.perf_counter() - t0}), flush=True)
            agg = sound if side == "program" else control
            for k, v in readings.items():
                agg.setdefault(k, []).append(v)
    print(json.dumps({"workload": args.workload,
                      "lower": {k: max(v) for k, v in sound.items()},
                      "upper": {k: min(v) for k, v in control.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
