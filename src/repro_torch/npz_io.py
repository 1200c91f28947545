"""The ``.npz`` file format shared by the port's checkpoints (the JAX
package's ``save_pytree`` format): one member per leaf and a
``__manifest__`` member, the UTF-8 JSON ``{"keys": [...], "meta": {...}}``.
The LM training state (``training.checkpoint``) and the engine's BSP carries
(``core.engine``) are both written and read here.

``save_flat`` writes a temporary file of its own in the target's directory
(``tempfile.mkstemp``) and moves it into place with ``os.replace``: two
writers never share a temporary name, and a reader sees the old file or
the new one, never a part.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np


def save_flat(path: str, flat: dict, extra_meta: Optional[dict] = None):
    """Atomically write ``{key: numpy array}`` to ``path`` with
    ``extra_meta`` in the manifest. Returns ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    meta = {"keys": sorted(flat), "meta": extra_meta or {}}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __manifest__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_flat(path: str):
    """(``{key: numpy array}``, meta) of a file in the format."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        flat = {k: z[k] for k in manifest["keys"]}
    return flat, manifest["meta"]
