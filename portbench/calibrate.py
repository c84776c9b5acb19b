"""Readings that the output check's limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 3]

For each seed, the program's readings against the plain reference (sound
runs: the lower reading); for each control seed also the control's (the
reference computed with TF32 products in the program's place) and those
of the faults planted in the reference put in the program's place: half
of the frame left out of the loss (``half``), a cotangent or count
altered where it is produced (``alter``) and, where the compared steps
hold a densify event, its output altered: every densify decision moved to
the next row (``clone_pick``), a split's scale left undivided
(``split_scale``).  One JSON line per seed and
kind.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys

import torch

import run
import scenes
from reference import gs as ref


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(lc, seed, dev, control: bool) -> list[dict]:
    st = run.setup_train(lc, seed, dev)
    del st["trainer"]
    _free(dev)
    base = run.reference_train(lc, seed, st, dev, ref.Prec("fp32"))
    out = [{"kind": "program", **run.compare_train(st["prog"], base),
            "program_raw": st["prog"], "reference_raw": base}]
    if control:
        kinds = [("control", "tf32", None), ("half", "fp32", "half"),
                 ("alter", "fp32", "alter")]
        if st["events"]:
            kinds += [("clone_pick", "fp32", "clone_pick"),
                      ("split_scale", "fp32", "split_scale")]
        for kind, prec, fault in kinds:
            other = run.reference_train(lc, seed, st, dev, ref.Prec(prec),
                                        fault)
            out.append({"kind": kind, **run.compare_train(other, base)})
    return out


def view_readings(lc, seed, dev, control: bool, seconds: float) -> list[dict]:
    res = run.run_view(lc, seed, seconds, False, dev)
    out = [{"kind": "program", **res["numbers"]}]
    _free(dev)
    if control:
        cfg, tr = lc["config"], lc["traffic"]
        rs = run.ref_settings(cfg)
        fov = math.radians(cfg["fov_y_deg"])
        params = scenes.make_scene(cfg, seed, dev)
        alive = torch.ones(params["means"].shape[0], dtype=torch.bool,
                           device=dev)
        poses = scenes.ring_poses(cfg, seed, tr["orbit_frames"], salt=4,
                                  ordered=True)
        gaps = {"control": [], "alter": []}
        for pos, rot in poses[:tr["compare_frames"]]:
            cam = ref.camera(pos, rot, cfg["width"], cfg["height"], fov, dev)
            base = ref.render(params, alive, cam, cfg["sh_degree"], rs,
                              ref.Prec("fp32"))["image"]
            low = ref.render(params, alive, cam, cfg["sh_degree"], rs,
                             ref.Prec("tf32"))["image"]
            # an answer altered where it is produced: one tile row black
            alt = base.clone()
            alt[:16] = 0.0
            for k, img in (("control", low), ("alter", alt)):
                gaps[k].append(float(torch.sqrt(
                    ((img - base).double() ** 2).mean())))
        for k, v in gaps.items():
            out.append({"kind": k, "frame_rms_gap": max(v)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lc = run.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in sorted(set(seeds) | control):
        if lc["traffic"]["kind"] == "train":
            rows = train_readings(lc, seed, dev, seed in control)
        else:
            rows = view_readings(lc, seed, dev, seed in control,
                                 args.seconds)
        for row in rows:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              **row}), flush=True)
        _free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
