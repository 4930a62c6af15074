"""``kmc_water`` — single-excess-proton water KMC driver.

Legacy-compatible surface of the reference's excess-proton main
(KMC/excess_kmc.py:311-492): subcommands ``load`` (run a keyword config file),
``config_help`` and ``config_file``; column output with Step/Time/position/
neighbor/jumps/fps (Output, excess_kmc.py:280-308) or xyz output.
"""

from __future__ import annotations

import argparse
import sys
import time as _time

import numpy as np


def kmc_water_main(settings, out=None):
    out = out or sys.stdout

    import jax
    import jax.numpy as jnp

    from cmdlmc_tpu.config.keyword import print_settings
    from cmdlmc_tpu.core.cell import Cell
    from cmdlmc_tpu.io.hdf5 import HDF5Trajectory
    from cmdlmc_tpu.io.stream import frame_blocks, prefetch
    from cmdlmc_tpu.io.xyz import XYZTrajectory, write_xyz_frame
    from cmdlmc_tpu.models import water as wm
    from cmdlmc_tpu.rates.laws import Fermi
    from cmdlmc_tpu.topo.transforms import (
        InterpolatedTransformation,
        LinearTransformation,
        ReLUTransformation,
    )

    print_settings(settings, out=out)

    if getattr(settings, "debug", False):
        # reference: debug flag switches to DEBUG-level logging
        # (excess_kmc.py:314-320)
        import logging

        logging.basicConfig(
            level=logging.DEBUG,
            format="%(levelname)s:%(filename)s.%(funcName)s(%(lineno)d): %(message)s",
        )

    dt = settings.md_timestep_fs
    p = settings.jumprate_params_fs
    # The reference multiplies 'a' by the MD timestep to get a per-frame
    # probability and feeds frame-probabilities to the clock
    # (excess_kmc.py:398-401); our clock integrates rate * dt itself, so 'a'
    # stays a rate in fs^-1.
    missing = [k for k in ("a", "b", "c") if k not in p]
    if missing:
        raise ValueError(
            "jumprate_params_fs must provide Fermi parameters a, b and c "
            f"(e.g. 'jumprate_params_fs a=0.06 b=2.3 c=0.1'); missing: "
            f"{', '.join(missing)}"
        )
    law = Fermi(a=jnp.float32(p["a"]), b=jnp.float32(p["b"]), c=jnp.float32(p["c"]))

    transform = None
    if getattr(settings, "no_rescaling", False):
        # no_rescaling overrides rescale_function/conversion_data
        # (excess_kmc.py:419-420)
        pass
    elif settings.conversion_data:
        data = np.loadtxt(settings.conversion_data)
        dist, conversion = data[:, 0], data[:, -1]
        transform = InterpolatedTransformation(
            x=jnp.asarray(dist, jnp.float32), y=jnp.asarray(conversion, jnp.float32)
        )
    elif settings.rescale_function == "linear":
        rp = settings.rescale_parameters
        transform = LinearTransformation(
            a=jnp.float32(rp["a"]), b=jnp.float32(rp["b"]),
            left_bound=jnp.float32(rp["left_bound"]),
            right_bound=jnp.float32(rp["right_bound"]),
        )
    elif settings.rescale_function in ("ramp", "ramp_function"):
        # the reference's keyword value is 'ramp_function'
        # (config_parser.py:426-433)
        rp = settings.rescale_parameters
        transform = ReLUTransformation(
            a=jnp.float32(rp["a"]), b=jnp.float32(rp["b"]), d0=jnp.float32(rp["d0"]),
            left_bound=jnp.float32(rp["left_bound"]),
            right_bound=jnp.float32(rp["right_bound"]),
        )

    cell = Cell.from_parameter_array(settings.pbc)
    model = wm.WaterModel(
        cell=cell,
        law=law,
        transform=transform,
        d_oh=jnp.float32(settings.d_oh),
        n_atoms=settings.n_atoms,
        relaxation_time=settings.relaxation_time,
        waiting_time=settings.waiting_time,
        keep_last_neighbor_rescaled=settings.keep_last_neighbor_rescaled,
        check_from_old=settings.check_from_old,
    )

    fname = settings.filename
    if fname is None:
        raise ValueError("KMCWater config needs 'filename'")
    if fname.endswith((".h5", ".hdf5")):
        traj = HDF5Trajectory(fname, time_step=dt, repeat=False)
    else:
        traj = XYZTrajectory(fname, time_step=dt, repeat=False)

    key = jax.random.key(settings.seed)
    states = None
    keys = None
    start_time = _time.time()
    printed_header = False

    block_size = int(getattr(settings, "chunk_size", None) or 512)
    # mdconvert trajectories are in nm; the lattice works in angstrom
    # (excess_kmc.py:353-356)
    unit_scale = 10.0 if getattr(settings, "mdconvert_trajectory", False) else 1.0

    for block in prefetch(
        frame_blocks(traj, block_size=block_size, donor_atoms="O",
                     max_frames=settings.sweeps)
    ):
        donors_host = np.asarray(block.donors)
        if unit_scale != 1.0:
            donors_host = donors_host * unit_scale
        positions = jnp.asarray(donors_host, jnp.float32)
        if states is None:
            n_sites = positions.shape[1]
            states = wm.init_water_states(
                jax.random.fold_in(key, 0), settings.replicas, n_sites,
                positions[0], start_position=settings.start_position,
            )
            keys = jax.random.split(jax.random.fold_in(key, 1), settings.replicas)
        idx = jnp.arange(
            block.start, block.start + block.n_frames, dtype=jnp.int32
        )
        states, sites, msd = wm.run_water_block(
            model, states, keys, positions, idx, dt=dt
        )
        sites_np = np.asarray(jax.device_get(sites))  # [B, R]
        jumps0 = int(np.asarray(states.jumps)[0])
        corr0 = np.asarray(states.correction)[0]
        donors_np = donors_host

        if not printed_header and not settings.xyz_output:
            print(
                "# {:>16} {:>18} {:>15} {:>15} {:>15} {:>10} {:>10} {:>8}".format(
                    "Step", "Time", "x", "y", "z", "O-Neighbor", "Jumps", "fps"
                ),
                file=out,
            )
            printed_header = True

        for i in range(block.n_frames):
            step = block.start + i
            if step % settings.print_frequency:
                continue
            site0 = int(sites_np[i, 0])
            pos = donors_np[i, site0] + corr0
            fps = (step + 1) / max(_time.time() - start_time, 1e-9)
            if settings.xyz_output:
                write_xyz_frame(
                    out,
                    ["H"] + ["O"] * donors_np.shape[1],
                    np.vstack([pos[None, :], donors_np[i]]),
                )
            else:
                print(
                    "{:18d} {:18.2f} {:15.8f} {:15.8f} {:15.8f} {:10d} {:10d} "
                    "{:8.2f}".format(
                        step, step * dt, pos[0], pos[1], pos[2], site0, jumps0, fps
                    ),
                    file=out,
                    flush=True,
                )


def main(argv=None):
    from cmdlmc_tpu.config.keyword import (
        load_configfile,
        print_config_template,
        print_confighelp,
    )

    parser = argparse.ArgumentParser(description="Single-excess-proton water KMC")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_load = sub.add_parser("load", help="Load config file")
    p_load.add_argument("config_file")
    p_load.add_argument("--platform", default=None)
    sub.add_parser("config_help", help="Keyword help")
    p_tmpl = sub.add_parser("config_file", help="Print config template")
    p_tmpl.add_argument("--sorted", "-s", action="store_true")
    args = parser.parse_args(argv)

    if args.cmd == "config_help":
        print_confighelp("KMCWater")
    elif args.cmd == "config_file":
        print_config_template("KMCWater", args.sorted)
    else:
        if args.platform:
            import jax

            jax.config.update("jax_platforms", args.platform)
        settings = load_configfile(args.config_file, config_name="KMCWater")
        if getattr(settings, "output", None):
            with open(settings.output, "w") as out:
                kmc_water_main(settings, out=out)
        else:
            kmc_water_main(settings)


if __name__ == "__main__":
    main()
