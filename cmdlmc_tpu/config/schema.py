"""INI-compatible configuration surface.

Keeps the reference's config-file shape (section names, ``type =`` selectors,
inline ``#`` comments — main.py:56-158) so existing cMD/LMC configs port with
minimal edits, while replacing signature-introspection string coercion
(main.py:22-45 ``convert_to_match_signature``) with explicit typed schemas.

New knobs live in an ``[Engine]`` section: replica count (vmapped
independent KMC chains), mandatory RNG seed (the reference's new-style path had
no seed plumbing at all — SURVEY.md §5.2), per-frame event bound, streaming
block size and device-mesh controls.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Any, Optional

import numpy as np


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "on")


def _parse_vector(s: str) -> np.ndarray:
    return np.fromstring(str(s).strip().strip("[]()"), dtype=float, sep=",")


def _parse_selection(s: str):
    s = str(s).strip()
    if s in ("", "None", "none"):
        return None
    if s[0] in "[(":
        inner = s.strip("[]()")
        parts = [p.strip() for p in inner.split(",") if p.strip()]
        if all(p.lstrip("-").isdigit() for p in parts):
            return [int(p) for p in parts]
        return tuple(p.strip("'\"") for p in parts)
    if s.lstrip("-").isdigit():
        return [int(s)]
    return s


_COERCERS = {
    bool: _parse_bool,
    int: lambda s: int(float(s)),
    float: float,
    str: str,
}


def coerce_section(cls, raw: dict[str, str]):
    """Instantiate a schema dataclass from a raw INI section, coercing strings
    by field type. Unknown keys raise (typo protection the reference lacked);
    'None' maps to None, 'EMPTY' raises like the reference (main.py:38-39)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for key, value in raw.items():
        key = key.lower()
        if key == "type":
            key = "type_"
        removed = _REMOVED.get((cls.__section__, key))
        if removed:
            raise KeyError(
                f"Option {key!r} of section [{cls.__section__}] was removed: "
                f"{removed}. Delete it from the config."
            )
        if key not in fields:
            raise KeyError(
                f"Unknown option {key!r} for section [{cls.__section__}]; "
                f"valid options: {sorted(k.rstrip('_') for k in fields)}"
            )
        if isinstance(value, str):
            if value == "EMPTY":
                raise ValueError(
                    f"Keyword {key} is EMPTY. Please specify a value in the config file."
                )
            if value == "None":
                kwargs[key] = None
                continue
        f = fields[key]
        typ = f.metadata.get("parse") or f.type
        if callable(typ) and not isinstance(typ, str):
            kwargs[key] = typ(value)
        else:
            base = str(typ).replace("Optional[", "").rstrip("]")
            coercer = {
                "bool": _parse_bool,
                "int": lambda s: int(float(s)),
                "float": float,
                "str": str,
            }.get(base.split(".")[-1], str)
            kwargs[key] = coercer(value)
    return cls(**kwargs)


# Options that earlier versions accepted, with why each went. A config that
# still sets one gets this reason instead of a generic unknown-option error.
_REMOVED = {
    ("Engine", "tile"): "it sized the replica tiles of the removed fused "
                        "Pallas backend",
    ("Engine", "nbr_reuse"): "it switched neighbor-list reuse in the removed "
                             "fused top-K backend",
}


def _field(parse=None, default=dataclasses.MISSING, default_factory=dataclasses.MISSING):
    md = {"parse": parse} if parse else {}
    if default_factory is not dataclasses.MISSING:
        return dataclasses.field(default_factory=default_factory, metadata=md)
    if default is not dataclasses.MISSING:
        return dataclasses.field(default=default, metadata=md)
    return dataclasses.field(metadata=md)


@dataclasses.dataclass
class TrajectorySection:
    __section__ = "Trajectory"
    filename: str
    time_step: float
    type_: str = "XYZTrajectory"
    number_of_atoms: Optional[int] = None
    selection: Any = _field(parse=_parse_selection, default=None)
    repeat: bool = False
    chunk_size: int = 1000
    stride: int = 1  # use every stride-th frame (legacy skip_frames + 1)
    clip: Optional[int] = None  # use only the first clip frames (clip_trajectory)
    shuffle_seed: Optional[int] = None  # legacy shuffle mode (HDF5 only)


@dataclasses.dataclass
class AtomBoxSection:
    __section__ = "AtomBox"
    periodic_boundaries: np.ndarray = _field(parse=_parse_vector)
    type_: str = "AtomBoxCubic"
    box_multiplier: Any = _field(
        parse=lambda s: tuple(int(x) for x in _parse_vector(s)), default=(1, 1, 1)
    )


@dataclasses.dataclass
class TopologySection:
    __section__ = "NeighborTopology"
    type_: str = "NeighborTopology"
    donor_atoms: str = "O"
    cutoff: float = 3.0
    buffer: float = 2.0
    extra_atoms: Optional[str] = None
    group_size: int = 3
    neighbors: int = 4  # hydronium K (reference n_atoms, config_parser.py:540-546)
    # K-nearest neighbor-list variant of NeighborTopology (the reference's
    # Verlet-list option, topology.py:80-114): avoids the dense [N, N] rate
    # matrix for large supercells. None = dense.
    max_neighbors: Optional[int] = None


@dataclasses.dataclass
class JumpRateSection:
    __section__ = "JumpRate"
    type_: str = "Fermi"
    a: float = 0.0
    b: float = 0.0
    c: float = 1.0
    theta: float = 0.0
    A: float = 0.0
    d0: float = 0.0
    T: float = 300.0


@dataclasses.dataclass
class KMCLatticeSection:
    __section__ = "KMCLattice"
    lattice_size: Optional[int]  # None = derive from the trajectory donor count
    proton_number: int
    donor_atoms: str = "O"
    time_step: Optional[float] = None  # falls back to trajectory time_step
    extra_atoms: Optional[str] = None


@dataclasses.dataclass
class OutputSection:
    __section__ = "Output"
    type_: str = "ObservablesOutput"
    reset_frequency: int = 0
    print_frequency: int = 1
    particle_type: str = "H"
    variance: bool = False  # also print variance columns
    # what the variance columns measure: "replicas" (across independent KMC
    # chains; this framework's natural ensemble statistic) or "protons" (the
    # reference's variance_per_proton: across proton trajectories within a
    # chain, config_parser.py:356-363, averaged over replicas)
    variance_mode: str = "replicas"
    replica_dump: Optional[str] = None  # npz path for per-replica observables
    periodic_wrap: bool = False  # wrap xyz-output positions into the box
    higher_msd: bool = False  # also print the 4th displacement moment column
    filename: Optional[str] = None  # write output here instead of stdout
    # distance-resolved jump statistics (the jumpstat capability,
    # reference README.md:57-58): > 0 enables on-device jump/exposure
    # histograms, printed as a '# jumpstat' block at the end of the run
    jumpstat_bins: int = 0
    jumpstat_range: Any = _field(
        parse=lambda s: tuple(float(x) for x in _parse_vector(s)),
        default=(2.0, 3.0),
    )


@dataclasses.dataclass
class DistanceTransformationSection:
    __section__ = "DistanceTransformation"
    type_: str = "ReLUTransformation"
    a: float = 0.0
    b: float = 0.0
    d0: float = 0.0
    left_bound: float = 0.0
    right_bound: float = 0.0
    dist_array_filename: Optional[str] = None
    conversion_array_filename: Optional[str] = None


@dataclasses.dataclass
class DistanceInterpolatorSection:
    __section__ = "DistanceInterpolator"
    relaxation_time: float = 0.0


@dataclasses.dataclass
class EngineSection:
    __section__ = "Engine"
    replicas: int = 1
    seed: int = 0
    max_events_per_frame: int = 4
    block_size: int = 256
    sweeps: Optional[int] = None  # total frames; None = full trajectory
    # Multi-device: number of devices to shard the replica axis over.
    # "auto" (default) = all visible devices unless the platform is the CPU,
    # 1 there; "all" = all visible devices on any platform; an integer pins
    # the count. replicas must divide evenly.
    devices: str = "auto"
    mesh_axis: str = "replica"  # mesh axis name for the replica dimension
    jumpmatrix_filename: Optional[str] = None  # legacy jumpmatrix capability
    checkpoint_path: Optional[str] = None  # .npz path; resume if it exists
    checkpoint_interval: int = 0  # blocks between checkpoints (0 = end only)
    backend: str = "auto"  # auto | scan: both run the scan engine
    equilibration_sweeps: int = 0  # frames before observables start (legacy)
    # Reference-style stale in-frame rates (MDMC.py:121-171): intra-frame
    # events draw from the frame-start rate rows (masked by current
    # occupancy) and the clock integrates the frame-start total, instead of
    # recomputing after each event. Differs from the default only at
    # O(rate*dt) within multi-event frames. Dense topologies only.
    stale_rates: bool = False


_SECTIONS = {
    "Trajectory": TrajectorySection,
    "AtomBox": AtomBoxSection,
    "NeighborTopology": TopologySection,
    "JumpRate": JumpRateSection,
    "KMCLattice": KMCLatticeSection,
    "Output": OutputSection,
    "DistanceTransformation": DistanceTransformationSection,
    "DistanceInterpolator": DistanceInterpolatorSection,
    "Engine": EngineSection,
}


@dataclasses.dataclass
class SimulationConfig:
    trajectory: TrajectorySection
    atombox: AtomBoxSection
    topology: TopologySection
    jumprate: JumpRateSection
    kmc: KMCLatticeSection
    output: OutputSection
    engine: EngineSection
    transformation: Optional[DistanceTransformationSection] = None
    interpolator: Optional[DistanceInterpolatorSection] = None
    logging_level: Optional[str] = None


def load_config(path_or_file) -> SimulationConfig:
    cp = configparser.ConfigParser(inline_comment_prefixes=("#",))
    if hasattr(path_or_file, "read"):
        cp.read_file(path_or_file)
    else:
        with open(path_or_file) as f:
            cp.read_file(f)

    def section(name, required=True):
        if name not in cp:
            if required:
                raise KeyError(f"Config file is missing required section [{name}]")
            return None
        return coerce_section(_SECTIONS[name], dict(cp[name]))

    return SimulationConfig(
        trajectory=section("Trajectory"),
        atombox=section("AtomBox"),
        topology=section("NeighborTopology"),
        jumprate=section("JumpRate"),
        kmc=section("KMCLattice"),
        output=section("Output"),
        engine=section("Engine", required=False) or EngineSection(),
        transformation=section("DistanceTransformation", required=False),
        interpolator=section("DistanceInterpolator", required=False),
        logging_level=cp["Logging"]["level"] if "Logging" in cp else None,
    )
