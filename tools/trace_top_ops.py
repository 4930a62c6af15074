"""Reduce a jax.profiler trace to device busy time and the top device ops.

    python -m cmdlmc_tpu.cli.mdmc run.ini --profile TRACE_DIR
    python tools/trace_top_ops.py TRACE_DIR --frames 300 --top 5

For every device plane of the newest ``*.xplane.pb`` under TRACE_DIR it
prints the names and event counts of its lines, the busy time (union of the
kernel intervals on its streams), the idle share of the traced window, the
busy time per frame when ``--frames`` is given, and the ``--top`` operations
by summed device time (from the "XLA Ops" line when the plane has one, else
from the kernels).
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import defaultdict


def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames simulated in the traced run")
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args(argv)

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(args.trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise SystemExit(f"no .xplane.pb under {args.trace_dir}")
    data = ProfileData.from_file(paths[-1])
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {line.name: list(line.events) for line in plane.lines}
        print(f"{plane.name}: lines " +
              ", ".join(f"{k!r}={len(v)}" for k, v in lines.items()))
        kernels = [e for name, evs in lines.items()
                   if name.lower().startswith("stream") for e in evs]
        ops = lines.get("XLA Ops") or kernels
        if not ops:
            continue
        every = [e for evs in lines.values() for e in evs]
        window = (max(e.end_ns for e in every)
                  - min(e.start_ns for e in every))
        busy = union_ns((e.start_ns, e.end_ns) for e in (kernels or ops))
        print(f"  window {window / 1e6:.3f} ms, busy {busy / 1e6:.3f} ms, "
              f"idle share {1 - busy / window:.4f}")
        if args.frames:
            print(f"  busy per frame {busy / args.frames / 1e3:.3f} us "
                  f"over {args.frames} frames")
        by_name = defaultdict(float)
        count = defaultdict(int)
        for e in ops:
            by_name[e.name] += e.duration_ns
            count[e.name] += 1
        total = sum(by_name.values())
        for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[
                : args.top]:
            print(f"  {ns / 1e6:10.3f} ms {100 * ns / total:6.2f}% "
                  f"x{count[name]:<7d} {name[:120]}")


if __name__ == "__main__":
    main()
