"""``mdmc`` console entry point — INI-config-driven cMD/LMC run
(reference main.py:56-158)."""

from __future__ import annotations

import argparse


def main(argv=None):
    """Run ``mdmc``; returns the finished :class:`~cmdlmc_tpu.driver.Simulation`
    so in-process callers can inspect its final state."""
    parser = argparse.ArgumentParser(
        description="cMD/LMC kinetic Monte Carlo run",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "configfile", help="INI file configuring the cMD/LMC scheme"
    )
    parser.add_argument(
        "--legacy",
        action="store_true",
        help="Treat the config as a legacy cMDLMC keyword-per-line file",
    )
    parser.add_argument(
        "--platform",
        default=None,
        help="Force a JAX platform (e.g. cpu) instead of the default device",
    )
    parser.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="Capture a jax.profiler trace of the run into DIR "
             "(view with TensorBoard / Perfetto)",
    )
    args = parser.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import contextlib

    if args.profile:
        import jax

        profile_cm = jax.profiler.trace(args.profile)
    else:
        profile_cm = contextlib.nullcontext()

    with profile_cm:
        if args.legacy:
            from cmdlmc_tpu.config.legacy import load_legacy_config
            from cmdlmc_tpu.driver import Simulation

            sim = Simulation(load_legacy_config(args.configfile))
            sim.run()
        else:
            from cmdlmc_tpu.driver import run_from_config

            sim = run_from_config(args.configfile)
    return sim


if __name__ == "__main__":
    main()
