#!/usr/bin/env python3
"""Time variants of the FAST/NMS CUDA kernel on one card, within one run.

    python3 scripts/time_fast_nms.py [--tiles 64x16,32x16] [--source other.cu ...]

Every variant is a kernel source (the package's csrc/fast_nms.cu, plus any
given with --source, which must keep its C interface) compiled at one tile
shape. Each is checked bitwise against the plain PyTorch version on a random
integer pyramid and on the pyramid of one rendered 752x480 bench-world stereo
pair (8 levels, scale 1.2, B=2), then timed on the rendered pyramid: 20
launches captured in a CUDA graph, the graph replayed 20 times between CUDA
events, so no host time is in the way. The variants take turns over
--rounds rounds; the table gives each round and the median. The package's
own variant is also timed as a caller sees it (200 eager calls between CUDA
events, Python wrapper included), and --sass prints the opcode histogram of
its compiled kernel (needs cuobjdump). Needs a CUDA card and nvcc; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import HARD_WORLD, card_line  # noqa: E402  (the bench world, the card's line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", default="64x16", help="comma-separated TXxTY, 256 threads a tile")
    ap.add_argument("--source", action="append", default=[], help="another kernel source to time")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass", action="store_true", help="opcode histogram of the first variant")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_fast_nms.py: no CUDA device", file=sys.stderr)
        return 2
    from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
    from orbslam3_tpu_torch.ops import fast_cuda as fc
    from orbslam3_tpu_torch.ops.pyramid import build_pyramid, level_shapes

    card = card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rand = [torch.from_numpy(rng.integers(0, 256, (2,) + hw).astype(np.float32)).to(dev)
            for hw in level_shapes(480, 752, 8, 1.2)]
    world = SyntheticWorld(SyntheticConfig(duration=1.0, n_landmarks=1500, **HARD_WORLD))
    pair = torch.from_numpy(np.stack(world.render_frame(0.0)).astype(np.float32)).to(dev)
    frame = [lv.contiguous() for lv in build_pyramid(pair, 8, 1.2)]
    want = [[fc.fast_nms_reference(lv) for lv in lvs] for lvs in (rand, frame)]

    base_flags = [f for f in fc.NVCC_FLAGS if not f.startswith(("-DFAST_TX", "-DFAST_TY"))]
    variants = []
    for src in [fc.SOURCE] + [Path(p).resolve() for p in args.source]:
        for tile in args.tiles.split(","):
            tx, ty = map(int, tile.split("x"))
            variants.append((f"{os.path.relpath(src, ROOT)} {tx}x{ty}", src, tx, ty))

    def select(src, tx, ty):
        """Rebind the binding's module constants to one variant."""
        fc.SOURCE, fc.TILE_X, fc.TILE_Y = src, tx, ty
        fc.NVCC_FLAGS = base_flags + [f"-DFAST_TX={tx}", f"-DFAST_TY={ty}"]
        fc._lib = None
        fc.level_table.cache_clear()

    graphs = {}
    for name, src, tx, ty in variants:
        select(src, tx, ty)
        info = fc.build()
        regs = [ln.strip() for ln in info.get("ptxas", "").splitlines() if "registers" in ln]
        for lvs, refs in zip((rand, frame), want):
            for got, ref in zip(fc.fast_nms_levels(lvs), refs):
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name}: not bitwise equal at {tuple(ref.shape)}")
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(20):
                fc.fast_nms_levels(frame)
        graphs[name] = g
        print(f"{name}: built in {info['seconds']:.1f} s, bitwise equal; {' '.join(regs)}", flush=True)

    times = {name: [] for name in graphs}
    for _ in range(args.rounds):
        for name, g in graphs.items():
            for _ in range(3):
                g.replay()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                g.replay()
            t1.record()
            torch.cuda.synchronize()
            times[name].append(t0.elapsed_time(t1) / 400 * 1e3)
    name, src, tx, ty = variants[0]
    select(src, tx, ty)
    for _ in range(3):
        fc.fast_nms_levels(frame)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(200):
        fc.fast_nms_levels(frame)
    t1.record()
    torch.cuda.synchronize()
    print(f"{name}: 200 eager calls, {t0.elapsed_time(t1) / 200 * 1e3:.3f} microseconds a call "
          f"(Python wrapper included)  [{card}]")
    if args.sass:
        sass = subprocess.run([str(Path(fc._nvcc()).with_name("cuobjdump")), "-sass",
                               fc.build()["path"]], capture_output=True, text=True, check=True)
        ops = collections.Counter()
        for ln in sass.stdout.splitlines():
            m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_]+)", ln)
            if m:
                ops[m.group(1)] += 1
        print(f"{name}: {sum(ops.values())} SASS instructions (static): "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(16)))
    print(f"microseconds a frame (one launch, 8 levels, B=2), graph replay  [{card}]")
    for name, ts in times.items():
        print(f"  {name:48s} median {statistics.median(ts):8.3f}   rounds "
              + " ".join(f"{t:8.3f}" for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
