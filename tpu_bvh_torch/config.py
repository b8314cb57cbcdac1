"""Runtime configuration of the app: the port of `tpu_bvh.config`.

The reference selects its builder, traversal variant and scene at compile
time; here they are a dataclass and a CLI with JAX's flags and defaults.
`device` is the port's own field: "cuda" (the card) unless `--cpu` asks
for the CPU, where every op takes its plain version.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

BUILDERS = ("two_pass", "single_pass", "ploc", "hploc", "binned_sah", "batched")
TRAVERSAL_VARIANTS = ("if_if", "while_while", "speculative", "restart_trail", "raster")
SCENES = ("cornellbox", "bunny_like", "sponza_like")


@dataclass
class EngineConfig:
    builder: str = "two_pass"
    traversal: str = "speculative"  # the reference's default
    scene: str = "cornellbox"
    width: int = 512
    height: int = 512
    use_extended_morton: bool = True  # both LBVH paths use extended codes
    split_clip_sa_max: float = float("inf")  # the reference's prim splitting is off
    collapse: bool = True
    heatmap: bool = False
    out_image: str = "test.png"
    out_heatmap: str = "colorMap.png"
    device: str = "cuda"

    def validate(self) -> "EngineConfig":
        if self.builder not in BUILDERS:
            raise ValueError(f"unknown builder {self.builder!r}; expected one of {BUILDERS}")
        if self.traversal not in TRAVERSAL_VARIANTS:
            raise ValueError(f"unknown traversal {self.traversal!r}; "
                             f"expected one of {TRAVERSAL_VARIANTS}")
        return self


def parse_args(argv=None) -> EngineConfig:
    p = argparse.ArgumentParser(description="tpu_bvh_torch demo driver")
    p.add_argument("--builder", choices=BUILDERS, default="two_pass")
    p.add_argument("--traversal", choices=TRAVERSAL_VARIANTS, default="speculative")
    p.add_argument("--scene", default="cornellbox", help="preset name or path to .obj")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--plain-morton", action="store_true")
    p.add_argument("--split-clip", type=float, default=float("inf"), metavar="SA_MAX")
    p.add_argument("--no-collapse", action="store_true")
    p.add_argument("--heatmap", action="store_true")
    p.add_argument("--out", default="test.png")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    a = p.parse_args(argv)
    return EngineConfig(
        builder=a.builder,
        traversal=a.traversal,
        scene=a.scene,
        width=a.width,
        height=a.height,
        use_extended_morton=not a.plain_morton,
        split_clip_sa_max=a.split_clip,
        collapse=not a.no_collapse,
        heatmap=a.heatmap,
        out_image=a.out,
        device="cpu" if a.cpu else "cuda",
    ).validate()
