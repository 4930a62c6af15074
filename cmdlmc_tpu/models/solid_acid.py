"""Solid-acid (CsH2PO4-type) cMD/LMC model family — the flagship model.

Thin builder layer over the generic engine: donor sites are oxygens streamed
from the MD trajectory, rates follow the Fermi law (optionally gated by the
P-O-O angle), and the multi-proton lattice engine advances vmapped replica
ensembles. The config-driven path lives in cmdlmc_tpu.driver; this module is
the programmatic API for the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from cmdlmc_tpu.core.cell import Cell
from cmdlmc_tpu.engine import lattice as eng
from cmdlmc_tpu.rates.laws import Fermi, FermiAngle
from cmdlmc_tpu.topo.models import AnglePairRates, Frame, PairRates


@dataclasses.dataclass
class SolidAcidModel:
    """Bundle of (cell, rate model, ensemble, keys) ready to advance."""

    cell: Cell
    rate_model: object
    ensemble: eng.EnsembleState
    keys: jax.Array
    dt: float

    @classmethod
    def create(
        cls,
        *,
        box,
        first_frame_donors,
        n_protons: int,
        fermi_a: float,
        fermi_b: float,
        fermi_c: float,
        dt: float,
        n_replicas: int = 1024,
        cutoff: float = 3.0,
        buffer: float = 2.0,
        angle_theta: Optional[float] = None,
        first_frame_extras=None,
        group_size: int = 3,
        seed: int = 0,
        hist_bins: int = 0,
        track_jump_matrix: bool = False,
    ) -> "SolidAcidModel":
        cell = Cell.from_parameter_array(box)
        f32 = jnp.float32
        donors0 = jnp.asarray(first_frame_donors, jnp.float32)
        if angle_theta is not None:
            law = FermiAngle(
                a=f32(fermi_a), b=f32(fermi_b), c=f32(fermi_c), theta=f32(angle_theta)
            )
            rate_model = AnglePairRates.from_first_frame(
                cell, law, cutoff=cutoff, buffer=buffer,
                donors0=donors0,
                extras0=jnp.asarray(first_frame_extras, jnp.float32),
                group_size=group_size,
            )
        else:
            law = Fermi(a=f32(fermi_a), b=f32(fermi_b), c=f32(fermi_c))
            rate_model = PairRates(
                cell=cell, law=law, cutoff=f32(cutoff), buffer=f32(buffer)
            )
        key = jax.random.key(seed)
        n_sites = donors0.shape[0]
        ensemble = eng.init_replicas(
            jax.random.fold_in(key, 0), n_replicas, n_sites, n_protons, donors0,
            hist_bins=hist_bins, track_jump_matrix=track_jump_matrix,
        )
        keys = jax.random.split(jax.random.fold_in(key, 1), n_replicas)
        return cls(
            cell=cell, rate_model=rate_model, ensemble=ensemble, keys=keys,
            dt=dt,
        )

    def advance(
        self,
        donor_positions,  # [B, N, 3]
        frame0: int,
        *,
        extras=None,
        reset_frequency: int = 0,
        emit_every: int = 1,
        max_events: int = 4,
    ):
        """Advance the ensemble over a frame block; returns per-frame ObsRows."""
        pos = jnp.asarray(donor_positions, jnp.float32)
        idx = jnp.arange(frame0, frame0 + pos.shape[0], dtype=jnp.int32)
        frames = Frame(
            donors=pos,
            extras=None if extras is None else jnp.asarray(extras, jnp.float32),
            time=idx.astype(jnp.float32) * jnp.float32(self.dt),
            index=idx,
        )
        self.ensemble, rows = eng.run_block(
            self.rate_model, self.cell, self.ensemble, self.keys, frames,
            dt=self.dt, max_events=max_events, reset_frequency=reset_frequency,
            emit_every=emit_every,
        )
        return rows
