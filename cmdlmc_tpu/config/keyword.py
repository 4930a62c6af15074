"""Legacy keyword-per-line config system.

Re-provides the reference's second config generation (IO/config_parser.py:
13-561): one ``key value...`` pair per line, ``#`` comments, per-key parse
functions, defaults and help strings, with two schemas — ``cMDLMC`` (the
multi-proton solid-acid scheme) and ``KMCWater`` (the single-excess-proton
water scheme) — plus the ``config_help`` / ``config_file`` introspection
surface (print_confighelp / print_config_template, config_parser.py:97-126).
"""

from __future__ import annotations

import textwrap
from types import SimpleNamespace

import numpy as np


def parse_int(tokens):
    return int(float(tokens[0]))


def parse_float(tokens):
    return float(tokens[0])


def parse_string(tokens):
    return tokens[0]


def parse_bool(tokens):
    return tokens[0].lower() in ("true", "1", "yes", "on")


def _strip_brackets(tokens):
    # tolerate the reference template's python-list repr: "[1, 1, 1]"
    joined = " ".join(tokens).replace("[", " ").replace("]", " ").replace(",", " ")
    return joined.split()


def parse_floats(tokens):
    return np.array([float(t) for t in _strip_brackets(tokens)])


def parse_ints(tokens):
    return [int(t) for t in _strip_brackets(tokens)]


def parse_dict(tokens):
    """``a=1 b=2``, ``a 1 b 2``, or the reference's python dict syntax
    ``{'a': 1, 'b': 2}`` / ``dict(a=1, b=2)`` (IO/config_parser.py:13-16
    get_dictionary) -> dict of floats."""
    joined = " ".join(tokens)
    if "{" in joined:
        import ast

        literal = joined[joined.index("{"): joined.rindex("}") + 1]
        return {str(k): float(v) for k, v in ast.literal_eval(literal).items()}
    if joined.startswith("dict"):
        inner = joined[joined.index("(") + 1: joined.rindex(")")]
        tokens = [t.strip() for t in inner.split(",") if t.strip()]
    out = {}
    if any("=" in t for t in tokens):
        for t in tokens:
            k, _, v = t.partition("=")
            out[k.strip()] = float(v)
    else:
        for k, v in zip(tokens[::2], tokens[1::2]):
            out[k] = float(v)
    return out


NO_DEFAULT = object()

# (key, parse_fct, default, help)
_COMMON = [
    ("filename", parse_string, None,
     "Trajectory file (xyz or HDF5). cMDLMC configs may instead give "
     "'auxiliary_file'."),
    ("pbc", parse_floats, NO_DEFAULT,
     "Periodic boundaries: 3 values (orthogonal) or 9 (full cell vectors)."),
    ("md_timestep_fs", parse_float, NO_DEFAULT, "Time between two MD frames in fs."),
    ("sweeps", parse_int, NO_DEFAULT, "Number of KMC sweeps (frames) to run."),
    ("print_frequency", parse_int, 1, "Print output every n frames."),
    ("seed", parse_int, 0, "RNG seed (threefry; every replica derives from it)."),
    ("verbose", parse_bool, False, "Verbose output."),
    ("xyz_output", parse_bool, False, "Print xyz frames instead of columns."),
    ("replicas", parse_int, 1,
     "Number of vmapped independent KMC replicas (extension of the reference)."),
    ("output", parse_string, None,
     "Write column output to this file instead of stdout."),
]

CONFIG_SCHEMAS: dict[str, list] = {
    "cMDLMC": _COMMON + [
        ("equilibration_sweeps", parse_int, 0, "Discarded sweeps before output."),
        ("reset_freq", parse_int, 0, "Reset observables every n frames."),
        ("proton_number", parse_int, NO_DEFAULT, "Number of protons on the lattice."),
        ("lattice_size", parse_int, None,
         "Number of donor sites (extension; derived from the trajectory donor "
         "count if unset, like the reference)."),
        ("box_multiplier", parse_ints, [1, 1, 1],
         "Extend the LMC box along one or more dimensions."),
        ("donor_atoms", parse_string, "O", "Donor/acceptor atom type."),
        ("jumprate_type", parse_string, "MD_rates",
         "MD_rates (Fermi), AE_rates (Arrhenius activation energy) or "
         "Exponential_rates."),
        ("jumprate_params_fs", parse_dict, NO_DEFAULT,
         "Fermi: a b c — omega(d) = a / (1 + exp((d - b) / c)). "
         "AE: A a b d0 T — E(d) = a (d - d0)/sqrt(b + 1/(d - d0)^2), "
         "omega = A exp(-E/(kB T)). Exponential: a b — omega = a exp(b d)."),
        ("cutoff_radius", parse_float, 3.0, "Neighbor cutoff in Angstrom."),
        ("neighbor_search_radius", parse_float, 5.0,
         "Cutoff + buffer used when building the topology."),
        ("angle_threshold", parse_float, 0.0,
         "Minimum P-O-O angle (radians); 0 disables angle gating."),
        ("angle_dependency", parse_bool, True,
         "If False, ignore angle_threshold (no angle gating) even when an "
         "angle threshold is set (config_parser.py:463-468)."),
        ("o_neighbor", parse_string, "P",
         "Name of the heavy atoms the donor oxygens are bonded to, for "
         "angle-dependent jump rates (config_parser.py:175-181)."),
        ("jumpmatrix_filename", parse_string, None,
         "If given, save the pairwise jump-count matrix here."),
        ("higher_msd", parse_bool, False,
         "Also print the 4th displacement moment column."),
        ("variance_per_proton", parse_bool, False,
         "Print across-replica variance columns."),
        ("skip_frames", parse_int, 0,
         "Frames to skip between topology updates: every (skip_frames+1)-th "
         "trajectory frame is used, and each used frame covers the full "
         "physical interval (config_parser.py:196-202)."),
        ("clip_trajectory", parse_int, None,
         "Use only the first n trajectory frames; if sweeps exceeds it, the "
         "clipped trajectory is looped (config_parser.py:237-243)."),
        ("shuffle", parse_bool, False,
         "Choose trajectory frames uniformly at random (seeded); requires an "
         "HDF5 trajectory (config_parser.py:275-281)."),
        ("periodic_wrap", parse_bool, False,
         "Wrap xyz-output positions into the periodic box "
         "(config_parser.py:294-299)."),
        ("neighbor_list", parse_bool, False,
         "Use a K-nearest neighbor list instead of the dense pair-rate matrix "
         "(the reference's Verlet-list option, topology.py:80-114); K is "
         "chosen from neighbor_search_radius."),
        ("auxiliary_file", parse_string, None,
         "Alternate name for the coordinate file; used when 'filename' is "
         "absent. An .xyz file is converted to a compressed .hdf5 next to it "
         "(config_parser.py:161-168)."),
        ("hdf5", parse_bool, False,
         "Convert an .xyz trajectory to compressed HDF5 once and stream from "
         "that (recommended for large trajectories)."),
    ],
    "KMCWater": _COMMON + [
        ("relaxation_time", parse_int, 0,
         "Frames over which rates blend from unrescaled to rescaled distances "
         "after a jump."),
        ("waiting_time", parse_int, 0, "Frames of zero jump rate after a jump."),
        ("jumprate_params_fs", parse_dict, NO_DEFAULT,
         "Fermi parameters a b c of the jump rate."),
        ("rescale_function", parse_string, "none",
         "Distance rescaling: linear, ramp, or none."),
        ("rescale_parameters", parse_dict, {},
         "Parameters of the rescale function (a, b, d0, left_bound, right_bound)."),
        ("conversion_data", parse_string, None,
         "File with tabulated distance conversion (overrides rescale_function)."),
        ("d_oh", parse_float, 0.0,
         "O-H bond length correction applied along each jump."),
        ("start_position", parse_int, None,
         "Starting oxygen index; random if unset."),
        ("n_atoms", parse_int, 3, "Neighbors per site (3 or 4)."),
        ("keep_last_neighbor_rescaled", parse_bool, False,
         "Keep the connection to the previous oxygen rescaled."),
        ("check_from_old", parse_bool, True,
         "Also check the old oxygen's neighbor list for a back connection "
         "(reference default: True, config_parser.py:530-535)."),
        ("chunk_size", parse_int, 1000,
         "Trajectory streaming block size in frames (config_parser.py:399-404)."),
        ("no_rescaling", parse_bool, False,
         "If True, distances are not rescaled — overrides rescale_function and "
         "conversion_data (config_parser.py:445-450, excess_kmc.py:419-420)."),
        ("debug", parse_bool, False,
         "Enable DEBUG-level logging (config_parser.py:469-474)."),
        ("mdconvert_trajectory", parse_bool, False,
         "If the trajectory was written by mdconvert, convert coordinates from "
         "nm to angstrom (x10; config_parser.py:518-523, excess_kmc.py:353-356)."),
        ("overwrite_jumprates", parse_bool, False,
         "Obsolete here (accepted for reference-config compatibility): the "
         "reference used it to refresh its HDF5 jump-rate cache; this framework "
         "recomputes neighbor distances on device every run."),
        ("overwrite_oxygen_trajectory", parse_bool, False,
         "Obsolete here (accepted for reference-config compatibility): the "
         "reference used it to refresh its cached HDF5 oxygen trajectory."),
    ],
}

# Alternate key spellings accepted per schema: the reference's cMDLMC schema
# names the print cadence 'print_freq' (config_parser.py:203-208) while
# KMCWater (and this framework) use 'print_frequency'.
ALIASES: dict[str, dict[str, str]] = {
    "cMDLMC": {"print_freq": "print_frequency"},
    "KMCWater": {},
}

# Keys that are accepted and parsed but have no effect in this framework
# (warned about at load time). Both managed the reference's derived-data HDF5
# cache (excess_kmc.py:331-365,406-413), which this framework replaced with
# on-device recomputation.
OBSOLETE: dict[str, tuple[str, ...]] = {
    "cMDLMC": (),
    "KMCWater": ("overwrite_jumprates", "overwrite_oxygen_trajectory"),
}

# Placeholder values the reference's own print_config_template emits for
# required/None defaults (config_parser.py:117-126): such lines are treated
# as "key present but unset" so a template loads unmodified. The stdout repr
# is what the reference prints for the 'output' key's default.
_PLACEHOLDERS = ("no_default", "<MISSING", "<_io.TextIOWrapper")


def load_configfile(path_or_file, config_name: str = "cMDLMC") -> SimpleNamespace:
    """Parse a keyword config file into a namespace with defaults applied
    (config_parser.py:60-94)."""
    schema = CONFIG_SCHEMAS[config_name]
    keys = {k: (parse, default) for k, parse, default, _ in schema}
    aliases = ALIASES.get(config_name, {})
    obsolete = OBSOLETE.get(config_name, ())
    settings = {}
    if hasattr(path_or_file, "read"):
        lines = path_or_file.read().splitlines()
    else:
        with open(path_or_file) as f:
            lines = f.read().splitlines()
    for lineno, line in enumerate(lines, 1):
        line = line.split("#")[0].strip()
        if not line:
            continue
        tokens = line.split()
        key, args = tokens[0], tokens[1:]
        key = aliases.get(key, key)
        if key not in keys:
            raise KeyError(f"Unknown keyword {key!r} on line {lineno}")
        if args and args[0] in _PLACEHOLDERS:
            continue  # template placeholder: leave unset
        if key in obsolete:
            import sys

            print(
                f"# WARNING: keyword {key!r} has no effect in this framework "
                "(the reference's HDF5 derived-data cache does not exist here)",
                file=sys.stderr,
            )
        parse, _ = keys[key]
        try:
            settings[key] = None if args == ["None"] else parse(args)
        except (IndexError, ValueError) as exc:
            raise ValueError(
                f"Keyword {key!r} on line {lineno} needs a value "
                f"(got {' '.join(args)!r}): {exc}"
            ) from exc
    for k, (parse, default) in keys.items():
        if k not in settings:
            if default is NO_DEFAULT:
                raise ValueError(f"Missing required keyword {k!r}")
            settings[k] = default
    return SimpleNamespace(**settings)


def print_confighelp(config_name: str = "cMDLMC", out=None):
    """Help text for every keyword (config_parser.py:97-114)."""
    import sys

    out = out or sys.stdout
    for key, _, default, help_ in CONFIG_SCHEMAS[config_name]:
        default_str = "(required)" if default is NO_DEFAULT else f"default: {default}"
        print(f"{key}", file=out)
        print(textwrap.indent(textwrap.fill(help_, 70), "    "), file=out)
        print(f"    {default_str}\n", file=out)


def print_config_template(config_name: str = "cMDLMC", sorted_: bool = False, out=None):
    """Commented config template (config_parser.py:117-126)."""
    import sys

    out = out or sys.stdout
    schema = CONFIG_SCHEMAS[config_name]
    if sorted_:
        schema = sorted(schema, key=lambda e: e[0])
    for key, _, default, help_ in schema:
        print(f"# {help_}", file=out)
        if default is NO_DEFAULT:
            print(f"{key}  # REQUIRED", file=out)
        else:
            if isinstance(default, dict):
                default_str = " ".join(f"{k}={v}" for k, v in default.items())
            elif isinstance(default, (list, tuple, np.ndarray)):
                default_str = " ".join(str(v) for v in default)
            else:
                default_str = str(default)
            print(f"{key} {default_str}".rstrip(), file=out)
        print(file=out)


def print_settings(settings: SimpleNamespace, out=None):
    """Echo all settings as '#' comments (config_parser.py:136-148)."""
    import sys

    out = out or sys.stdout
    for k in sorted(vars(settings)):
        print(f"# {k} {getattr(settings, k)}", file=out)
