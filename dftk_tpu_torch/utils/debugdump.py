"""Debug state dumps on rare numerical failures.

Port of `dftk_tpu/utils/debugdump.py` (reference `src/common/debugdump.jl`):
when an SCF goes wrong in a hard-to-reproduce way, dump the offending
arrays to an npz for offline inspection.  Enabled by setting
DFTK_TPU_DEBUG_DUMP to a directory path (off by default, like the
reference's preference gate); the file format is the JAX package's.
"""
import json
import os
import time

import numpy as np

from . import to_numpy


def dump_enabled():
    return bool(os.environ.get("DFTK_TPU_DEBUG_DUMP"))


def debug_dump(tag, meta=None, **arrays):
    """Write arrays + scalar metadata to $DFTK_TPU_DEBUG_DUMP/<tag>-<ts>.npz.

    No-op unless DFTK_TPU_DEBUG_DUMP is set.  Returns the path or None.
    """
    target = os.environ.get("DFTK_TPU_DEBUG_DUMP")
    if not target:
        return None
    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, f"{tag}-{int(time.time() * 1000)}.npz")
    payload = {k: to_numpy(v) for k, v in arrays.items()}
    payload["meta"] = np.frombuffer(
        json.dumps(meta or {}, default=float).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)
    return path


def load_dump(path):
    with np.load(path) as data:
        out = {k: data[k] for k in data.files if k != "meta"}
        out["meta"] = json.loads(bytes(data["meta"]).decode())
    return out
