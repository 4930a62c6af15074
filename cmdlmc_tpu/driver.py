"""Simulation driver: config -> object graph -> streamed KMC run.

The counterpart of the reference's ``mdmc`` entry point
(main.py:56-158). The reference builds a chain of Python generators and prints
whatever the output iterable yields; here the driver

  1. builds the cell, trajectory reader, rate law and topology rate model,
  2. initializes a batch of vmapped replicas (explicitly seeded),
  3. streams trajectory frame blocks host -> device (prefetched), running the
     scan engine (engine/lattice.py) per block,
  4. formats reference-compatible, '#'-commented column output (the de-facto
     results format that the analysis tooling parses back — SURVEY.md §5.5).
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from cmdlmc_tpu.config.schema import SimulationConfig, load_config
from cmdlmc_tpu.core.cell import Cell, extended_positions
from cmdlmc_tpu.engine import lattice as eng
from cmdlmc_tpu.io.stream import frame_blocks, prefetch
from cmdlmc_tpu.io.xyz import XYZTrajectory, write_xyz_frame
from cmdlmc_tpu.rates import laws as rate_laws
from cmdlmc_tpu.topo import models as topo_models
from cmdlmc_tpu.topo import transforms as topo_transforms

logger = logging.getLogger(__name__)


def build_trajectory(cfg: SimulationConfig):
    t = cfg.trajectory
    if t.type_ == "XYZTrajectory":
        if t.shuffle_seed is not None:
            raise ValueError(
                "shuffle mode needs random frame access — convert the "
                "trajectory to HDF5 with trajconv first"
            )
        return XYZTrajectory(
            t.filename,
            time_step=t.time_step,
            number_of_atoms=t.number_of_atoms,
            selection=t.selection,
            repeat=t.repeat,
            stride=t.stride,
            clip=t.clip,
        )
    if t.type_ == "HDF5Trajectory":
        from cmdlmc_tpu.io.hdf5 import HDF5Trajectory

        return HDF5Trajectory(
            t.filename,
            time_step=t.time_step,
            selection=t.selection,
            repeat=t.repeat,
            chunk_size=t.chunk_size,
            stride=t.stride,
            clip=t.clip,
            shuffle_seed=t.shuffle_seed,
        )
    raise ValueError(f"Unknown trajectory type {t.type_!r}")


def build_cell(cfg: SimulationConfig) -> Cell:
    b = cfg.atombox
    if b.type_ == "AtomBoxCubic":
        return Cell.cubic(b.periodic_boundaries, b.box_multiplier)
    if b.type_ == "AtomBoxMonoclinic":
        return Cell.triclinic(b.periodic_boundaries, b.box_multiplier)
    raise ValueError(f"Unknown atom box type {b.type_!r}")


def build_law(cfg: SimulationConfig):
    j = cfg.jumprate
    f32 = jnp.float32
    if j.type_ == "Fermi":
        return rate_laws.Fermi(a=f32(j.a), b=f32(j.b), c=f32(j.c))
    if j.type_ == "FermiAngle":
        return rate_laws.FermiAngle(a=f32(j.a), b=f32(j.b), c=f32(j.c), theta=f32(j.theta))
    if j.type_ in ("AE", "ActivationEnergy"):
        return rate_laws.ActivationEnergy(
            A=f32(j.A), a=f32(j.a), b=f32(j.b), d0=f32(j.d0), T=f32(j.T)
        )
    if j.type_ == "Exponential":
        return rate_laws.Exponential(a=f32(j.a), b=f32(j.b))
    if j.type_ == "Constant":
        return rate_laws.Constant(a=f32(j.a))
    raise ValueError(f"Unknown jump rate type {j.type_!r}")


def build_transformation(cfg: SimulationConfig):
    tr = cfg.transformation
    if tr is None:
        return None
    f32 = jnp.float32
    if tr.type_ == "ReLUTransformation":
        return topo_transforms.ReLUTransformation(
            a=f32(tr.a), b=f32(tr.b), d0=f32(tr.d0),
            left_bound=f32(tr.left_bound), right_bound=f32(tr.right_bound),
        )
    if tr.type_ == "LinearTransformation":
        return topo_transforms.LinearTransformation(
            a=f32(tr.a), b=f32(tr.b),
            left_bound=f32(tr.left_bound), right_bound=f32(tr.right_bound),
        )
    if tr.type_ == "InterpolatedTransformation":
        return topo_transforms.InterpolatedTransformation.from_file(
            tr.dist_array_filename, tr.conversion_array_filename
        )
    raise ValueError(f"Unknown distance transformation {tr.type_!r}")


def build_model(cfg: SimulationConfig, cell: Cell, law, first_block):
    topo = cfg.topology
    f32 = jnp.float32
    if topo.type_ == "NeighborTopology":
        if topo.max_neighbors:
            return topo_models.TopKPairRates(
                cell=cell, law=law, cutoff=f32(topo.cutoff),
                buffer=f32(topo.buffer), k=topo.max_neighbors,
            )
        return topo_models.PairRates(
            cell=cell, law=law, cutoff=f32(topo.cutoff), buffer=f32(topo.buffer)
        )
    if topo.type_ == "AngleTopology":
        if first_block.extras is None:
            raise ValueError("AngleTopology requires extra_atoms in the topology section")
        return topo_models.AnglePairRates.from_first_frame(
            cell,
            law,
            cutoff=topo.cutoff,
            buffer=topo.buffer,
            donors0=jnp.asarray(first_block.donors[0]),
            extras0=jnp.asarray(first_block.extras[0]),
            group_size=topo.group_size,
        )
    if topo.type_ == "HydroniumTopology":
        interp = None
        if cfg.interpolator is not None:
            interp = topo_transforms.DistanceInterpolator(
                relaxation_time=f32(cfg.interpolator.relaxation_time)
            )
        return topo_models.HydroniumRates(
            cell=cell,
            law=law,
            cutoff=f32(topo.cutoff),
            buffer=f32(topo.buffer),
            transform=build_transformation(cfg),
            interpolator=interp,
            k=topo.neighbors,
        )
    raise ValueError(f"Unknown topology type {topo.type_!r}")


def jumpstat_lines(states, hist_range, bins, dt):
    """Format the distance-resolved jump statistics accumulated by the
    engine's on-device histograms (jumpstat capability, reference
    README.md:57-58). Shared by the ``jumpstat`` CLI and the driver's
    [Output] jumpstat_bins surface."""
    jumps = np.asarray(states.replicas.jump_hist).sum(axis=0)
    opp = np.asarray(states.replicas.opportunity_hist).sum(axis=0)
    edges = np.linspace(hist_range[0], hist_range[1], bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    lines = [
        f"# jumpstat over [{hist_range[0]}, {hist_range[1]}] A, {bins} bins",
        "# estimator: omega(d) = jumps / (exposure * dt) — exposure-based "
        "rate estimate.",
        "# It is unbiased while omega*dt stays well below "
        "max_events_per_frame (tested at",
        "# omega*dt up to ~0.5); residual high-rate bias is "
        "O(omega*dt/max_events) from the",
        "# per-frame event budget plus end-of-frame exposure sampling — if "
        "the run printed",
        "# a truncation warning, raise [Engine] max_events_per_frame before "
        "trusting omega.",
        f"# {'d/A':>8} {'jumps':>10} {'exposure':>12} {'P(jump)':>12} "
        f"{'omega/fs^-1':>12}",
    ]
    for i in range(bins):
        p = jumps[i] / opp[i] if opp[i] > 0 else 0.0
        lines.append(
            f"{centers[i]:10.4f} {int(jumps[i]):10d} {opp[i]:12.1f} "
            f"{p:12.6g} {p / dt:12.6g}"
        )
    return lines


@dataclasses.dataclass
class ObservableRecord:
    frame: int
    time: float
    msd: np.ndarray  # [3]
    msd_var: np.ndarray  # [3]
    autocorr: float
    autocorr_var: float
    jumps: float
    msd4: float = 0.0  # 4th displacement moment (higher_msd)


class Simulation:
    """Configured simulation; iterate :meth:`observable_rows` or call
    :meth:`run` to print reference-format output."""

    def __init__(self, cfg: SimulationConfig):
        if (
            cfg.kmc.lattice_size is not None
            and cfg.kmc.proton_number > cfg.kmc.lattice_size
        ):
            raise ValueError(
                f"proton_number ({cfg.kmc.proton_number}) cannot exceed "
                f"lattice_size ({cfg.kmc.lattice_size})"
            )
        if cfg.kmc.proton_number < 1:
            raise ValueError("proton_number must be >= 1")
        if cfg.engine.replicas < 1:
            raise ValueError("[Engine] replicas must be >= 1")
        if cfg.engine.backend == "fused":
            raise ValueError(
                "[Engine] backend = fused was removed: the scan engine is the "
                "only backend; use backend = auto or scan"
            )
        if cfg.engine.backend not in ("auto", "scan"):
            raise ValueError(
                f"[Engine] backend must be 'auto' or 'scan', got "
                f"{cfg.engine.backend!r}"
            )
        d = str(cfg.engine.devices).strip().lower()
        if d not in ("auto", "all"):
            try:
                n = int(d)
            except ValueError:
                raise ValueError(
                    f"[Engine] devices must be 'auto', 'all' or an integer, "
                    f"got {cfg.engine.devices!r}"
                ) from None
            if n < 1:
                raise ValueError("[Engine] devices must be >= 1")
        self.cfg = cfg
        self.cell = build_cell(cfg)
        self.law = build_law(cfg)
        self.trajectory = build_trajectory(cfg)
        # Effective KMC time step: frame subsampling (legacy skip_frames) does
        # not compress physical time — each used frame covers the full
        # interval of the stride (IO/config_parser.py:196-202), so dt scales
        # by the stride.
        self.dt = float(cfg.kmc.time_step or cfg.trajectory.time_step) * max(
            int(cfg.trajectory.stride), 1
        )
        self.box_mult = tuple(cfg.atombox.box_multiplier)
        self._mult_total = int(np.prod(self.box_mult))
        # jump-statistics knobs (jumpstat CLI / jumpmatrix capability) —
        # config-surfaced as [Output] jumpstat_bins / jumpstat_range
        self.hist_bins = int(cfg.output.jumpstat_bins)
        self.hist_range = tuple(cfg.output.jumpstat_range)
        if cfg.output.variance_mode not in ("replicas", "protons"):
            raise ValueError(
                "[Output] variance_mode must be 'replicas' or 'protons', "
                f"got {cfg.output.variance_mode!r}"
            )
        self.track_jump_matrix = bool(cfg.engine.jumpmatrix_filename)
        self.final_states = None
        self._max_truncation = 0.0
        # steady-state perf bookkeeping (first block carries backend init +
        # compile; exclude it from the sustained rate)
        self._steady_t0 = None
        self._steady_frames0 = 0
        self._frames_run = 0  # frames simulated by this run (not resumed)
        self._n_devices = 1

    # -- multi-chip -------------------------------------------------------------

    def _resolve_mesh(self):
        """Build the replica mesh from [Engine] devices / mesh_axis, or None
        for a single-device run. 'auto' engages every visible accelerator
        (SURVEY.md §5.8: the replica axis is this framework's first-class
        scaling axis) and stays single-device on the CPU platform, so CPU
        runs only shard when asked to ('all' or an integer)."""
        e = self.cfg.engine
        spec = str(e.devices).strip().lower()
        avail = jax.devices()
        if spec == "auto":
            n = len(avail) if avail[0].platform != "cpu" else 1
        elif spec == "all":
            n = len(avail)
        else:
            n = int(spec)
        if n > len(avail):
            raise ValueError(
                f"[Engine] devices = {n} but only {len(avail)} devices are "
                "visible"
            )
        self._n_devices = max(n, 1)
        if n <= 1:
            return None
        if e.replicas % n:
            raise ValueError(
                f"[Engine] replicas ({e.replicas}) must be divisible by the "
                f"device count ({n})"
            )
        from cmdlmc_tpu.parallel.mesh import replica_mesh

        logger.info(
            "Sharding %d replicas over %d devices (axis %r)",
            e.replicas, n, e.mesh_axis,
        )
        return replica_mesh(avail[:n], axis=e.mesh_axis)

    # -- streaming --------------------------------------------------------------

    def _blocks(self, skip_until: int = 0):
        """Yield ``(block, frames)`` pairs with the host->device upload running
        on the prefetch thread: while the engine computes block k, block k+1 is
        parsed AND transferred. Blocks entirely before
        ``skip_until`` (checkpoint resume) skip the upload (frames=None)."""
        topo = self.cfg.topology
        gen = frame_blocks(
            self.trajectory,
            block_size=self.cfg.engine.block_size,
            donor_atoms=topo.donor_atoms,
            extra_atoms=topo.extra_atoms,
            max_frames=self.cfg.engine.sweeps,
        )

        def staged():
            for block in gen:
                if block.start + block.n_frames <= skip_until:
                    yield block, None
                else:
                    yield block, self._device_frames(block)

        return prefetch(staged())

    def _extend(self, positions: np.ndarray) -> np.ndarray:
        """Materialize the virtual supercell when box_multiplier != (1,1,1)."""
        if self._mult_total == 1:
            return positions
        base = np.asarray(self.cfg.atombox.periodic_boundaries, dtype=np.float32)
        if base.size == 3:
            vectors = np.diag(base)
        else:
            vectors = base.reshape(3, 3)
        out = [
            np.asarray(extended_positions(vectors, jnp.asarray(p), self.box_mult))
            for p in positions
        ]
        return np.stack(out)

    def _device_frames(self, block) -> topo_models.Frame:
        donors = jnp.asarray(self._extend(block.donors), dtype=jnp.float32)
        extras = (
            jnp.asarray(self._extend(block.extras), dtype=jnp.float32)
            if block.extras is not None
            else None
        )
        idx = jnp.arange(block.start, block.start + block.n_frames, dtype=jnp.int32)
        return topo_models.Frame(
            donors=donors,
            extras=extras,
            time=idx.astype(jnp.float32) * jnp.float32(self.dt),
            index=idx,
        )

    # -- main loop ---------------------------------------------------------------

    def observable_rows(self) -> Iterator[ObservableRecord]:
        return self._stream(xyz=False)

    def _stream(self, xyz: bool):
        """The single block-streaming engine behind :meth:`observable_rows`
        (yields :class:`ObservableRecord`) and :meth:`xyz_rows` (yields xyz
        frame strings). Checkpoint resume/save, model/mesh resolution and
        truncation accounting are shared; only the per-boundary emission
        differs."""
        from cmdlmc_tpu.utils.checkpoint import CheckpointWriter, load_checkpoint

        cfg = self.cfg
        model = None
        states = None
        keys = None
        n_sites_expected = cfg.kmc.lattice_size
        ckpt_path = cfg.engine.checkpoint_path
        # async writer: mid-run saves ride under the next blocks' kernels
        # (device arrays are immutable, so holding references is a snapshot)
        ckpt_writer = CheckpointWriter(ckpt_path) if ckpt_path else None
        resume_frame = 0
        blocks_done = 0
        last_frame_done = 0
        last_ckpt_frame = -1
        mesh = self._resolve_mesh()

        if ckpt_path:
            import os

            if os.path.exists(ckpt_path):
                states, keys, resume_frame, meta = load_checkpoint(ckpt_path)
                logger.info("Resuming from %s at frame %d", ckpt_path, resume_frame)
                fp = meta.get("config_fingerprint")
                if fp is not None and bytes(fp).decode() != config_fingerprint(cfg):
                    raise ValueError(
                        f"Checkpoint {ckpt_path} was written by a run with "
                        "different physics settings (trajectory/cell/rates/"
                        "topology/seed/replicas); refusing to resume. Delete "
                        "the checkpoint or restore the original config."
                    )
                # resuming exactly where we left off ensures a re-run of a
                # completed simulation does not double-simulate the trajectory
                last_frame_done = resume_frame

        for block, frames in self._blocks(skip_until=resume_frame):
            block_end_idx = block.start + block.n_frames
            if block_end_idx <= resume_frame:
                continue  # already simulated before the checkpoint
            if block.start < resume_frame:
                raise ValueError(
                    f"Checkpoint frame {resume_frame} falls inside the block "
                    f"[{block.start}, {block_end_idx}) — the checkpoint was "
                    "written with a different [Engine] block_size. Resume with "
                    "the original block_size (checkpoints record it in their "
                    "meta) or delete the checkpoint."
                )
            if model is None:
                model = build_model(cfg, self.cell, self.law, block)
                n_sites = frames.donors.shape[1]
                if n_sites_expected is not None and n_sites != n_sites_expected:
                    logger.warning(
                        "lattice_size=%d but trajectory provides %d donor sites; "
                        "using %d",
                        n_sites_expected, n_sites, n_sites,
                    )
                if states is None:
                    key = jax.random.key(cfg.engine.seed)
                    states = eng.init_replicas(
                        jax.random.fold_in(key, 0),
                        cfg.engine.replicas,
                        n_sites,
                        cfg.kmc.proton_number,
                        frames.donors[0],
                        hist_bins=self.hist_bins,
                        track_jump_matrix=self.track_jump_matrix,
                    )
                    keys = jax.random.split(
                        jax.random.fold_in(key, 1), cfg.engine.replicas
                    )
                if mesh is not None:
                    # split the replica axis over the mesh (checkpoint-loaded
                    # states arrive as host arrays and re-shard the same way);
                    # the scan engine partitions under GSPMD
                    from cmdlmc_tpu.parallel.mesh import (
                        shard_ensemble, shard_replicas,
                    )

                    states = shard_ensemble(states, mesh, cfg.engine.mesh_axis)
                    keys = shard_replicas(keys, mesh, cfg.engine.mesh_axis)
            run_kwargs = dict(
                dt=self.dt,
                max_events=cfg.engine.max_events_per_frame,
                reset_frequency=cfg.output.reset_frequency,
                equilibration=cfg.engine.equilibration_sweeps,
                stale_rates=cfg.engine.stale_rates,
            )
            if xyz:
                states, rows, sites = eng.run_block_with_sites(
                    model, self.cell, states, keys, frames, **run_kwargs
                )
                trunc = float(np.max(np.asarray(rows.truncated_mean)))
                if trunc > self._max_truncation:
                    self._max_truncation = trunc
                donors_np = np.asarray(jax.device_get(frames.donors))
                sites_np = np.asarray(jax.device_get(sites))
                for i in range(block.n_frames):
                    if block.start + i < cfg.engine.equilibration_sweeps:
                        continue
                    if (block.start + i) % cfg.output.print_frequency != 0:
                        continue
                    yield self._format_xyz(
                        donors_np[i], sites_np[i], block.start + i
                    )
            else:
                states, rows = eng.run_block(
                    model, self.cell, states, keys, frames,
                    hist_range=tuple(self.hist_range),
                    emit_every=cfg.output.print_frequency,
                    variance_mode=cfg.output.variance_mode,
                    **run_kwargs,
                )
                rows = jax.device_get(rows)
                trunc = float(np.max(np.asarray(rows.truncated_mean)))
                if trunc > self._max_truncation:
                    self._max_truncation = trunc
            blocks_done += 1
            self._frames_run += block.n_frames
            will_ckpt = (
                ckpt_path
                and cfg.engine.checkpoint_interval > 0
                and blocks_done % cfg.engine.checkpoint_interval == 0
            )
            if self._steady_t0 is None:
                import time as _t

                self._steady_t0 = _t.time()
                self._steady_frames0 = self._frames_run
            if will_ckpt:
                ckpt_writer.save(
                    states, keys, block_end_idx, meta=self._ckpt_meta()
                )
                last_ckpt_frame = block_end_idx
            if not xyz:
                for i in range(block.n_frames):
                    frame_no = int(rows.frame[i])
                    if frame_no < cfg.engine.equilibration_sweeps:
                        continue
                    if frame_no % cfg.output.print_frequency == 0:
                        yield ObservableRecord(
                            frame=frame_no,
                            time=float(rows.time[i]),
                            msd=np.asarray(rows.msd_mean[i]),
                            msd_var=np.asarray(rows.msd_var[i]),
                            autocorr=float(rows.autocorr_mean[i]),
                            autocorr_var=float(rows.autocorr_var[i]),
                            jumps=float(rows.jumps_mean[i]),
                            msd4=float(rows.msd4_mean[i]),
                        )
            last_frame_done = block_end_idx
        self.final_states = states
        if (ckpt_path and states is not None and blocks_done > 0
                and last_frame_done != last_ckpt_frame):
            # skip when the last block already checkpointed this exact frame
            # (a full state fetch + write for a byte-identical file)
            ckpt_writer.save(states, keys, last_frame_done,
                             meta=self._ckpt_meta())
        if ckpt_writer is not None:
            ckpt_writer.close()  # run is complete only once the file is

    def _ckpt_meta(self) -> dict:
        return {
            "seed": self.cfg.engine.seed,
            "block_size": self.cfg.engine.block_size,
            "config_fingerprint": np.bytes_(
                config_fingerprint(self.cfg).encode()
            ),
        }

    def _format_xyz(self, pos: np.ndarray, proton_sites: np.ndarray,
                    frame_no: int) -> str:
        import io as _io

        cfg = self.cfg
        if cfg.output.periodic_wrap:
            from cmdlmc_tpu.core.cell import wrap_positions

            pos = np.asarray(wrap_positions(self.cell, jnp.asarray(pos)))
        proton_pos = pos[proton_sites]
        names = [cfg.topology.donor_atoms] * len(pos) + [
            cfg.output.particle_type
        ] * len(proton_pos)
        buf = _io.StringIO()
        write_xyz_frame(
            buf, names, np.vstack([pos, proton_pos]),
            comment=f"frame {frame_no}",
        )
        return buf.getvalue().rstrip("\n")

    def xyz_rows(self) -> Iterator[str]:
        """XYZOutput mode: donor frames with proton pseudo-atoms of replica 0
        appended (MDMC.py:173-177). Same streaming engine as the observables
        path (:meth:`_stream`): mesh/checkpoint resolution, observable resets
        and truncation accounting are identical."""
        return self._stream(xyz=True)

    def run(self, out=None):
        import time as _time

        cfg = self.cfg
        close_out = False
        if out is None:
            if cfg.output.filename:
                out = open(cfg.output.filename, "w")
                close_out = True
            else:
                out = sys.stdout
        try:
            self._run(out, cfg, _time)
        finally:
            if close_out:
                out.close()

    def _run(self, out, cfg, _time):
        from cmdlmc_tpu.utils.version import version_lines

        for line in version_lines():
            print(line, file=out)
        print(f"# device: {device_description(len(jax.devices()))} visible",
              file=out)
        for line in config_echo(cfg):
            print(line, file=out)
        run_start = _time.time()
        if cfg.output.type_ == "XYZOutput":
            for row in self.xyz_rows():
                print(row, file=out)
            # event-budget telemetry parity with the observables path (the
            # xyz stream itself must stay parseable, so warn via the logger)
            if self._max_truncation > 0:
                logger.warning(
                    "up to %.2f%% of replicas hit max_events_per_frame in "
                    "some frame — raise [Engine] max_events_per_frame",
                    100 * self._max_truncation,
                )
            return
        header = ["Sweeps", "Time", "MSD_x", "MSD_y", "MSD_z", "Autocorr", "Jumps"]
        if cfg.output.higher_msd:
            header += ["MSD4"]
        if cfg.output.variance:
            header += ["MSD_var_x", "MSD_var_y", "MSD_var_z", "Autocorr_var"]
        print("# " + " ".join(f"{h:>12}" for h in header), file=out)
        for r in self.observable_rows():
            cols = [
                f"{r.frame:12d}",
                f"{r.time:14.2f}",
                f"{r.msd[0]:12.4f}",
                f"{r.msd[1]:12.4f}",
                f"{r.msd[2]:12.4f}",
                f"{r.autocorr:8.2f}",
                f"{r.jumps:8.2f}",
            ]
            if cfg.output.higher_msd:
                cols += [f"{r.msd4:12.4f}"]
            if cfg.output.variance:
                cols += [
                    f"{r.msd_var[0]:12.4f}",
                    f"{r.msd_var[1]:12.4f}",
                    f"{r.msd_var[2]:12.4f}",
                    f"{r.autocorr_var:8.2f}",
                ]
            print(" ".join(cols), file=out, flush=True)
        if self.hist_bins > 0 and self.final_states is not None:
            # INI-driven jumpstat block ([Output] jumpstat_bins/jumpstat_range)
            for line in jumpstat_lines(
                self.final_states, self.hist_range, self.hist_bins, self.dt
            ):
                print(line, file=out)
        if self.track_jump_matrix and self.final_states is not None:
            jumpmatrix = np.asarray(self.final_states.replicas.jump_matrix).sum(axis=0)
            np.save(cfg.engine.jumpmatrix_filename, jumpmatrix)
            print(
                f"# jump matrix saved to {cfg.engine.jumpmatrix_filename}",
                file=out,
            )
        if cfg.output.replica_dump and self.final_states is not None:
            rep = self.final_states.replicas
            msd, autocorr = eng.observables_of(rep, self.final_states.site_disp)
            np.savez_compressed(
                cfg.output.replica_dump,
                msd=np.asarray(msd),
                autocorrelation=np.asarray(autocorr),
                jumps=np.asarray(rep.jumps),
                event_count=np.asarray(rep.clock.event_count),
                site_of_proton=np.asarray(rep.site_of_proton),
            )
            print(f"# per-replica observables saved to {cfg.output.replica_dump}",
                  file=out)
        if self._max_truncation > 0:
            print(
                f"# WARNING: up to {100 * self._max_truncation:.2f}% of replicas "
                "hit max_events_per_frame in some frame — raise "
                "[Engine] max_events_per_frame",
                file=out,
            )
        # first-class perf meter (SURVEY.md §5.1: fps + site-updates/s column)
        elapsed = max(_time.time() - run_start, 1e-9)
        frames_done = self._frames_run
        if frames_done and self.final_states is not None:
            n_sites = self.final_states.replicas.occ.shape[-1]
            fps = frames_done / elapsed
            line = (
                f"# perf: {fps:.1f} frames/s, "
                f"{fps * cfg.engine.replicas * n_sites:.3e} site-updates/s"
            )
            if self._steady_t0 is not None and frames_done > self._steady_frames0:
                steady_fps = (frames_done - self._steady_frames0) / max(
                    _time.time() - self._steady_t0, 1e-9
                )
                line += (
                    f" (steady-state, excl. compile: {steady_fps:.1f} frames/s, "
                    f"{steady_fps * cfg.engine.replicas * n_sites:.3e} "
                    "site-updates/s)"
                )
            # a CPU run must never read as an accelerator number
            print(f"{line} on {device_description(self._n_devices)}", file=out)


def device_description(count: int) -> str:
    """``platform=<p> device_kind=<kind> count=<n>`` for output headers."""
    d = jax.devices()[0]
    return f"platform={d.platform} device_kind={d.device_kind} count={count}"


def config_fingerprint(cfg: SimulationConfig) -> str:
    """Hash of the physics-relevant configuration — stored in checkpoints so a
    resume under different physics (a different trajectory, rate law, seed,
    replica count, ...) fails loudly instead of silently mixing streams.
    Deliberately excludes execution knobs that may legitimately change across
    resumes (block_size, backend, checkpoint cadence, output options)."""
    import hashlib

    e = cfg.engine
    parts = [
        repr(cfg.trajectory), repr(cfg.atombox), repr(cfg.topology),
        repr(cfg.jumprate), repr(cfg.kmc), repr(cfg.transformation),
        repr(cfg.interpolator),
        f"replicas={e.replicas} seed={e.seed} "
        f"max_events={e.max_events_per_frame} "
        f"equilibration={e.equilibration_sweeps}",
    ]
    return hashlib.sha1("\n".join(parts).encode()).hexdigest()


def config_echo(cfg: SimulationConfig) -> list[str]:
    """Echo settings as '#' comments — downstream tooling recovers run
    parameters from these (average_MC_out.py:38-56).

    Every config section/key is printed (reference ``print_settings`` parity,
    IO/config_parser.py:136-148) so long runs are self-describing, followed by
    the canonical short keys the analysis round-trip parses. The short keys
    come last because the analysis scanner is last-match-wins
    (analysis/average.py::_settings_from_comments)."""
    lines = []
    for field in dataclasses.fields(cfg):
        section = getattr(cfg, field.name)
        if section is None or field.name == "logging_level":
            continue
        if not dataclasses.is_dataclass(section):
            continue
        lines.append(f"# [{getattr(type(section), '__section__', field.name)}]")
        for f in dataclasses.fields(section):
            value = getattr(section, f.name)
            if isinstance(value, np.ndarray):
                value = value.tolist()
            lines.append(f"# {f.name.rstrip('_')} = {value}")
    if cfg.logging_level:
        lines.append("# [Logging]")
        lines.append(f"# level = {cfg.logging_level}")
    lines.append(f"# sweeps {cfg.engine.sweeps if cfg.engine.sweeps else 0}")
    lines.append(f"# reset_freq {cfg.output.reset_frequency}")
    lines.append(f"# print_freq {cfg.output.print_frequency}")
    lines.append(f"# replicas {cfg.engine.replicas}")
    lines.append(f"# seed {cfg.engine.seed}")
    lines.append(f"# proton_number {cfg.kmc.proton_number}")
    lines.append(f"# lattice_size {cfg.kmc.lattice_size}")
    lines.append(f"# time_step {cfg.kmc.time_step or cfg.trajectory.time_step}")
    return lines


def run_from_config(path_or_file, out=None) -> Simulation:
    cfg = load_config(path_or_file)
    if cfg.logging_level:
        logging.basicConfig(level=cfg.logging_level.upper())
    sim = Simulation(cfg)
    sim.run(out=out)
    return sim
