"""Benchmark: KMC site-updates/s of the scan engine on the flagship shape.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "platform": ..., "device_kind":
   ..., "device_count": ...}

The metric is lattice site-updates per second (N_sites x replicas x frames /
wall s) on the reference integration scale (144 donor sites, 96 protons —
tests/integration/mdlmc_run.py:67-68 in the reference), for one timed pass over
pre-staged frame blocks, synchronised with ``jax.block_until_ready``. The
first block is a warm-up that carries compilation and is not timed.

It refuses to time the CPU unless asked (``--platform cpu``), so a CPU number
can never stand in for a device number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--replicas", type=int, default=16384)
    parser.add_argument("--sites", type=int, default=144)
    parser.add_argument("--protons", type=int, default=96)
    parser.add_argument("--block-frames", type=int, default=256)
    parser.add_argument("--blocks", type=int, default=4)
    parser.add_argument("--max-events", type=int, default=4)
    parser.add_argument("--print-frequency", type=int, default=100,
                        help="observable emission cadence (frames)")
    parser.add_argument("--stale", action="store_true",
                        help="reference-style stale in-frame rates")
    parser.add_argument("--platform", default=None,
                        help="force a JAX platform; 'cpu' allows a CPU run")
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    device = jax.devices()[0]
    if device.platform == "cpu" and args.platform != "cpu":
        print("bench.py: no accelerator found (pass --platform cpu to time "
              "the CPU)", file=sys.stderr)
        sys.exit(1)

    import jax.numpy as jnp

    from cmdlmc_tpu.core.cell import Cell
    from cmdlmc_tpu.engine import lattice as eng
    from cmdlmc_tpu.rates.laws import Fermi
    from cmdlmc_tpu.topo.models import Frame, PairRates

    rng = np.random.RandomState(0)
    positions = rng.uniform(0, 14.5, size=(args.sites, 3)).astype(np.float32)
    cell = Cell.cubic([14.5, 14.5, 14.5])
    model = PairRates(
        cell=cell,
        law=Fermi(a=jnp.float32(0.06), b=jnp.float32(2.3), c=jnp.float32(0.1)),
        cutoff=jnp.float32(3.0),
        buffer=jnp.float32(2.0),
    )
    key = jax.random.key(0)
    states = eng.init_replicas(
        jax.random.fold_in(key, 0),
        args.replicas,
        args.sites,
        args.protons,
        jnp.asarray(positions),
    )
    keys = jax.random.split(jax.random.fold_in(key, 1), args.replicas)

    def frames_for(start):
        # jittered copies of the base geometry so the rate matrix changes per frame
        jit_pos = positions[None] + rng.normal(
            scale=0.03, size=(args.block_frames, args.sites, 3)
        ).astype(np.float32)
        idx = jnp.arange(start, start + args.block_frames, dtype=jnp.int32)
        return Frame(
            donors=jnp.asarray(jit_pos),
            extras=None,
            time=idx.astype(jnp.float32) * 0.5,
            index=idx,
        )

    run_kwargs = dict(dt=0.5, max_events=args.max_events,
                      emit_every=args.print_frequency,
                      stale_rates=args.stale)

    # warm-up block: compilation
    states, rows = eng.run_block(model, cell, states, keys, frames_for(0),
                                 **run_kwargs)
    jax.block_until_ready((states, rows))

    staged = jax.device_put(
        [frames_for((b + 1) * args.block_frames) for b in range(args.blocks)]
    )
    jax.block_until_ready(staged)

    t0 = time.perf_counter()
    for blk in staged:
        states, rows = eng.run_block(model, cell, states, keys, blk,
                                     **run_kwargs)
    jax.block_until_ready((states, rows))
    elapsed = time.perf_counter() - t0
    site_updates = args.sites * args.replicas * args.blocks * args.block_frames
    print(
        json.dumps(
            {
                "metric": "kmc_site_updates_per_sec",
                "value": site_updates / elapsed,
                "unit": "site-updates/s",
                "platform": device.platform,
                "device_kind": device.device_kind,
                "device_count": 1,
            }
        )
    )


if __name__ == "__main__":
    main()
