"""Checkpoint / resume of simulation state.

The reference has no simulation-state persistence at all (SURVEY.md §5.4 —
closest thing is HDF5 caching of derived data). Here the full replica batch
(lattice occupancy, clock, observables, RNG keys, stream position) round-trips
through a single ``.npz``: because the engine's draw streams are keyed by event
ordinal, a resumed run continues bit-exactly where it left off (the same
property that makes host chunking invisible — engine/clock.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any

import jax
import numpy as np


def _flatten(prefix: str, obj, out: dict):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten(f"{prefix}{f.name}.", getattr(obj, f.name), out)
    else:
        out[prefix.rstrip(".")] = np.asarray(obj)


def _nested_class(field_name):
    from cmdlmc_tpu.engine.clock import ClockState
    from cmdlmc_tpu.engine.lattice import ReplicaState

    return {"clock": ClockState, "replicas": ReplicaState}[field_name]


def _rebuild(cls, prefix: str, data: dict):
    kwargs = {}
    for f in cls.__dataclass_fields__.values():
        key = f"{prefix}{f.name}"
        if any(k.startswith(key + ".") for k in data):
            kwargs[f.name] = _rebuild(_nested_class(f.name), key + ".", data)
        elif key in data:
            kwargs[f.name] = jax.numpy.asarray(data[key])
        else:
            raise KeyError(f"checkpoint is missing required field {key!r}")
    return cls(**kwargs)


def save_checkpoint(path: str, states, keys, next_frame: int,
                    meta: dict | None = None, compress: bool = False):
    """Persist replica states + RNG keys + stream position to ``path`` (.npz).

    Uncompressed by default: the state is a few tens of MB of nearly
    incompressible floats and zlib on this class of host costs seconds per
    save — enough to stall the device pipeline at soak checkpoint cadence.
    """
    out: dict[str, Any] = {}
    _flatten("state.", jax.device_get(states), out)
    out["keys"] = np.asarray(jax.random.key_data(keys))
    out["next_frame"] = np.int64(next_frame)
    out["state_class"] = np.bytes_(type(states).__name__.encode())
    if meta:
        for k, v in meta.items():
            out[f"meta.{k}"] = np.asarray(v)
    # Stage + atomic rename, for two reasons: a crash mid-write must never
    # leave a torn file where a resumable checkpoint used to be, and the
    # final open() must target the EXACT configured path (bare
    # np.savez_compressed appends ".npz" when missing, which would desync the
    # driver's resume existence check — `checkpoint_path = run.ckpt` would
    # save run.ckpt.npz and silently restart from frame 0 on every re-run).
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        (np.savez_compressed if compress else np.savez)(f, **out)
    os.replace(tmp, path)


class CheckpointWriter:
    """Overlaps checkpoint writes with device compute.

    ``save()`` holds references to the (immutable) device arrays and returns
    immediately; a worker thread then does the device→host fetch and the disk
    write while the main loop keeps dispatching kernels. Only one write is in flight: a new ``save()`` first joins the previous
    one (at checkpoint cadence the previous write has long finished).
    ``close()`` must be called before the run is declared complete.

    The worker is a NON-daemon thread: a dispatched save always lands, even
    when the driver generator is abandoned or an exception unwinds before
    ``close()`` — the interpreter joins it at shutdown, preserving the
    crash-recovery property the synchronous writer had (write failures in
    that window are logged immediately and re-raised on the next
    ``save()``/``close()`` if one happens).
    """

    def __init__(self, path: str, compress: bool = False):
        self.path = path
        self.compress = compress
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _run(self, states, keys, next_frame, meta):
        try:
            save_checkpoint(self.path, states, keys, next_frame,
                            meta=meta, compress=self.compress)
        except BaseException as e:  # surfaced on the next save()/close()
            import logging

            logging.getLogger(__name__).exception(
                "checkpoint write to %s failed", self.path
            )
            self._error = e

    def save(self, states, keys, next_frame: int, meta: dict | None = None):
        self.wait()
        self._thread = threading.Thread(
            target=self._run, args=(states, keys, next_frame, meta),
            name="ckpt-writer", daemon=False,
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()


def load_checkpoint(path: str):
    """Returns (states, keys, next_frame, meta)."""
    from cmdlmc_tpu.engine.lattice import EnsembleState, ReplicaState
    from cmdlmc_tpu.models.water import WaterState

    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    cls_name = bytes(data.pop("state_class")).decode()
    cls = {"ReplicaState": ReplicaState, "WaterState": WaterState,
           "EnsembleState": EnsembleState}[cls_name]
    state_data = {
        k[len("state."):]: v for k, v in data.items() if k.startswith("state.")
    }
    states = _rebuild(cls, "", state_data)
    keys = jax.random.wrap_key_data(jax.numpy.asarray(data["keys"]))
    next_frame = int(data["next_frame"])
    meta = {
        k[len("meta."):]: v for k, v in data.items() if k.startswith("meta.")
    }
    return states, keys, next_frame, meta
