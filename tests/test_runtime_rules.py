"""How the program meets its environment: the compile-cache location, h5py
as an optional dependency, options that were removed, the ``devices = auto``
rule, device names in the output, and the refusal of the GPU smoke test and
the benchmark to time a CPU."""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = """
[Trajectory]
type = {ttype}
filename = {traj}
time_step = 0.5

[AtomBox]
type = AtomBoxCubic
periodic_boundaries = 10, 10, 10

[NeighborTopology]
cutoff = 3.0
buffer = 2.0

[JumpRate]
type = Fermi
a = 0.1
b = 2.3
c = 0.3

[KMCLattice]
lattice_size = 12
proton_number = 4

[Output]
print_frequency = 4

[Engine]
replicas = 8
seed = 1
block_size = 8
{engine}
"""


def python(code_or_args, env_update=None, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update or {})
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    from cmdlmc_tpu.io.xyz import write_xyz_frame

    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 10, size=(12, 3))
    path = tmp_path_factory.mktemp("rules") / "t.xyz"
    with open(path, "w") as f:
        for _ in range(16):
            write_xyz_frame(f, ["O"] * 12,
                            pos + rng.normal(scale=0.02, size=pos.shape))
    return str(path)


def write_cfg(tmp_path, traj, engine="", ttype="XYZTrajectory"):
    path = tmp_path / "run.ini"
    path.write_text(CFG.format(traj=traj, engine=engine, ttype=ttype))
    return str(path)


# --- compile cache -----------------------------------------------------------

CACHE_PROBE = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
               "import cmdlmc_tpu; print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_defaults_to_the_checkout():
    out = python(CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_env_var_is_left_to_jax(tmp_path, monkeypatch):
    out = python(CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)
    # and the package sets nothing itself
    import jax

    import cmdlmc_tpu

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    cmdlmc_tpu._enable_persistent_compile_cache()
    assert calls == []


# --- h5py is optional -----------------------------------------------------------


def test_mdmc_runs_xyz_without_h5py(tmp_path, traj):
    cfg = write_cfg(tmp_path, traj)
    code = ("import sys; sys.modules['h5py'] = None\n"
            "from cmdlmc_tpu.cli import mdmc\n"
            f"mdmc.main([{cfg!r}, '--platform', 'cpu'])\n"
            "assert sys.modules['h5py'] is None\n")
    out = python(code)
    assert out.returncode == 0, out.stderr
    rows = [line for line in out.stdout.splitlines()
            if line and not line.startswith("#")]
    assert len(rows) == 4


def test_hdf5_trajectory_without_h5py_names_the_package(tmp_path, traj,
                                                        monkeypatch):
    from cmdlmc_tpu.config.schema import load_config
    from cmdlmc_tpu.driver import Simulation

    monkeypatch.setitem(sys.modules, "h5py", None)
    cfg = load_config(write_cfg(tmp_path, str(tmp_path / "t.h5"),
                                ttype="HDF5Trajectory"))
    with pytest.raises(ImportError, match="h5py"):
        Simulation(cfg)


# --- removed options --------------------------------------------------------------


@pytest.mark.parametrize("line,error,match", [
    ("tile = 64", KeyError, "tile.*removed"),
    ("nbr_reuse = on", KeyError, "nbr_reuse.*removed"),
    ("backend = fused", ValueError, "fused backend was removed|backend = fused"),
    ("backend = pallas", ValueError, "'auto' or 'scan'"),
])
def test_removed_engine_options_raise(tmp_path, traj, line, error, match):
    from cmdlmc_tpu.config.schema import load_config
    from cmdlmc_tpu.driver import Simulation

    with pytest.raises(error, match=match):
        Simulation(load_config(write_cfg(tmp_path, traj, engine=line)))


@pytest.mark.parametrize("backend", ["auto", "scan"])
def test_backend_values_run_the_scan_engine(tmp_path, traj, backend):
    from cmdlmc_tpu.config.schema import load_config
    from cmdlmc_tpu.driver import Simulation

    sim = Simulation(load_config(write_cfg(tmp_path, traj,
                                           engine=f"backend = {backend}")))
    out = io.StringIO()
    sim.run(out=out)
    assert sim.final_states.replicas.occ.shape == (8, 12)


@pytest.mark.parametrize("topology,ok", [("", True),
                                         ("max_neighbors = 4", False)])
def test_stale_rates_through_the_driver(tmp_path, traj, topology, ok):
    """[Engine] stale_rates runs dense topologies and names itself when a
    per-replica (top-K) topology rejects it."""
    from cmdlmc_tpu.config.schema import load_config
    from cmdlmc_tpu.driver import Simulation

    text = CFG.format(traj=traj, engine="stale_rates = True",
                      ttype="XYZTrajectory").replace(
        "buffer = 2.0", f"buffer = 2.0\n{topology}")
    sim = Simulation(load_config(io.StringIO(text)))
    if ok:
        sim.run(out=io.StringIO())
        assert sim.final_states.replicas.jumps.shape == (8,)
    else:
        with pytest.raises(ValueError, match="stale_rates"):
            sim.run(out=io.StringIO())


# --- devices = auto --------------------------------------------------------------


class _Device:
    """A CPU device that reports another platform."""

    def __init__(self, device, platform):
        self._device, self.platform = device, platform

    def __getattr__(self, name):
        return getattr(self._device, name)


@pytest.mark.parametrize("platform,spec,expected", [
    ("cpu", "auto", None),
    ("gpu", "auto", 8),
    ("cpu", "all", 8),
    ("gpu", "2", 2),
])
def test_devices_auto_rule(tmp_path, traj, monkeypatch, platform, spec,
                           expected):
    """'auto' takes every device unless the platform is the CPU."""
    import jax

    from cmdlmc_tpu import driver
    from cmdlmc_tpu.config.schema import load_config
    from cmdlmc_tpu.parallel import mesh as mesh_mod

    devices = [_Device(d, platform) for d in jax.devices()]
    monkeypatch.setattr(driver.jax, "devices", lambda: devices)
    monkeypatch.setattr(mesh_mod, "replica_mesh",
                        lambda devs, axis: ("mesh", len(devs), axis))
    sim = driver.Simulation(load_config(write_cfg(
        tmp_path, traj, engine=f"devices = {spec}")))
    got = sim._resolve_mesh()
    assert (got if got is None else got[1]) == expected


# --- device names in the output ------------------------------------------------------


def test_mdmc_output_names_the_device(tmp_path, traj):
    from cmdlmc_tpu.cli import mdmc

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sim = mdmc.main([write_cfg(tmp_path, traj), "--platform", "cpu"])
    text = buf.getvalue()
    assert "# device: platform=cpu device_kind=cpu" in text
    perf = [line for line in text.splitlines() if line.startswith("# perf:")]
    assert perf and perf[0].endswith("on platform=cpu device_kind=cpu count=1")
    assert sim.final_states is not None


# --- GPU-only entry points refuse the CPU --------------------------------------------


def _no_ok_line(out):
    return not any(line.startswith('{"ok"') for line in out.stdout.splitlines())


def test_chip_smoke_refuses_cpu():
    out = python(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert _no_ok_line(out)
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = python(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"}, cwd=tmp_path,
                 drop=("PYTHONPATH",))
    assert out.returncode != 0
    assert _no_ok_line(out)


def test_bench_refuses_cpu_unless_asked():
    out = python(["bench.py"], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert "no accelerator" in out.stderr
    assert out.stdout == ""


def test_bench_on_cpu_when_asked():
    import json

    out = python(["bench.py", "--platform", "cpu", "--replicas", "16",
                  "--sites", "24", "--protons", "8", "--block-frames", "8",
                  "--blocks", "2"])
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["platform"] == "cpu" and result["device_kind"] == "cpu"
    assert result["value"] > 0 and "vs_baseline" not in result


@pytest.fixture
def chip_smoke(tmp_path, monkeypatch):
    """chip_smoke.py imported as a module, at a tiny size, writing into
    tmp_path."""
    import functools
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "WORK", str(tmp_path))
    module.FLAGSHIP.update(replicas=16, frames=200, block_size=50,
                           print_frequency=50, reset_frequency=100)
    module.SUPERCELL.update(replicas=4, frames=100, block_size=50)
    module.WATER.update(replicas=8, frames=200)
    monkeypatch.setattr(module, "time_k_nearest",
                        functools.partial(module.time_k_nearest, reps=1))
    return module


@pytest.mark.parametrize("phase", ["flagship", "supercell", "water",
                                   "four_devices"])
def test_chip_smoke_phases_at_tiny_size_on_cpu(chip_smoke, phase, capsys):
    """Each phase's own checks pass on the CPU at a tiny size (the GPU is
    required only by main())."""
    from cmdlmc_tpu.io.synthetic import solid_acid_frames

    if phase == "flagship":
        chip_smoke.phase_flagship("cpu", 0)
    elif phase == "supercell":
        chip_smoke.phase_supercell("cpu", solid_acid_frames(100, 0)[1])
    elif phase == "water":
        chip_smoke.phase_water("cpu", 0)
    else:
        chip_smoke.phase_four_gpus("cpu", 0)
    assert "site-updates/s, device_kind=cpu" in capsys.readouterr().out
