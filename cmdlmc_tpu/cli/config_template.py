"""``mdlmc_config`` — auto-generated INI config template.

The reference walks all packages for ``__show_in_config__`` classes and derives
sections from constructor signatures (config.py:62-133); here the schema IS the
source of truth (config/schema.py dataclasses), so the template is generated by
introspecting those — same output shape: commented INI with per-key type
annotations and "EMPTY" markers for required values.
"""

from __future__ import annotations

import dataclasses
import sys

from cmdlmc_tpu.config import schema as S

_TYPE_CHOICES = {
    "Trajectory": ["XYZTrajectory", "HDF5Trajectory"],
    "AtomBox": ["AtomBoxCubic", "AtomBoxMonoclinic"],
    "NeighborTopology": ["NeighborTopology", "AngleTopology", "HydroniumTopology"],
    "JumpRate": ["Fermi", "FermiAngle", "AE", "Exponential", "Constant"],
    "Output": ["ObservablesOutput", "XYZOutput"],
    "DistanceTransformation": [
        "ReLUTransformation", "LinearTransformation", "InterpolatedTransformation"
    ],
}

_SECTION_HELP = {
    "Trajectory": "Source of MD frames.",
    "AtomBox": "Periodic boundary conditions (3 values cubic, 9 triclinic).",
    "NeighborTopology": "Donor-atom connectivity and collective variables.",
    "JumpRate": "Distance/angle-dependent jump rate law.",
    "KMCLattice": "Lattice and proton counts.",
    "Output": "Observables (columns) or xyz output.",
    "DistanceTransformation": "Optional O-O -> O-H3O+ distance rescaling.",
    "DistanceInterpolator": "Optional residence-time relaxation of rescaled distances.",
    "Engine": "Engine: replicas, seed, streaming and event bounds.",
}


def generate_template(out=None):
    out = out or sys.stdout
    for name, cls in S._SECTIONS.items():
        print(f"[{name}]", file=out)
        if name in _SECTION_HELP:
            print(f"# {_SECTION_HELP[name]}", file=out)
        for f in dataclasses.fields(cls):
            key = "type" if f.name == "type_" else f.name
            if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                value = "EMPTY"
            elif f.default_factory is not dataclasses.MISSING:
                value = f.default_factory()
            else:
                value = f.default
            comment = f"type {f.type}".replace("Optional[", "").rstrip("]")
            if key == "type" and name in _TYPE_CHOICES:
                comment = "choose between " + ", ".join(_TYPE_CHOICES[name])
            print(f"{key + ' = ' + str(value):42}# {comment}", file=out)
        print(file=out)


def main(argv=None):
    generate_template()


if __name__ == "__main__":
    main()
