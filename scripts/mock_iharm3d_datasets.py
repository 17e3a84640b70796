"""The datasets that scripts/generate_mock_simulation.py's iharm3d writers
put in a file, recorded in memory, for a machine without h5py:

    import generate_mock_simulation as mock
    from mock_iharm3d_datasets import record_datasets
    datasets = record_datasets(mock.write_iharm3d_fmks, fields, p)
    grid = blacklight_tpu_torch.grid.iharm3d.iharm3d_grid(
        datasets, cfg, device=device, dtype=dtype)

calls the writer with a stand-in for ``h5py.File`` that keeps each
``create_dataset``'s array under its path, which is what
``blacklight_tpu_torch.grid.iharm3d.read_iharm3d`` reads back from the
file h5py would write. The writers import the JAX package's ``grid.mks``
(numpy functions); the writer's own imports are served here with
``blacklight_tpu_torch.grid.mks``, the port's copy of the same
functions, so that neither JAX nor the JAX package is imported and
``sys.modules`` is left as it was.
"""

from __future__ import annotations

import builtins
import types

import numpy as np


class _RecordingFile:
    """h5py.File as the writers use it: a context manager whose
    create_dataset(name, data=..., dtype=...) stores the array."""

    def __init__(self, store: dict):
        self._store = store

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def create_dataset(self, name, data=None, dtype=None):
        self._store[name] = np.asarray(data, dtype=dtype)


def record_datasets(writer, *args, **kwargs) -> dict:
    """{path: numpy array} of the datasets ``writer(path, *args,
    **kwargs)`` would write (write_iharm3d or write_iharm3d_fmks)."""
    from blacklight_tpu_torch.grid import mks

    store = {}
    served = {
        "h5py": types.SimpleNamespace(
            File=lambda path, mode="r": _RecordingFile(store)),
        "blacklight_tpu.grid": types.SimpleNamespace(mks=mks),
    }
    real_import = builtins.__import__

    def serve(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name in served:
            return served[name]
        return real_import(name, globals, locals, fromlist, level)

    scope = dict(writer.__globals__,
                 __builtins__=dict(vars(builtins), __import__=serve))
    recorder = types.FunctionType(writer.__code__, scope, writer.__name__,
                                  writer.__defaults__, writer.__closure__)
    recorder.__kwdefaults__ = writer.__kwdefaults__
    recorder(None, *args, **kwargs)
    return store
