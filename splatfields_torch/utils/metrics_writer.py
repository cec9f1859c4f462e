"""Training metrics log (counterpart of ``splatfields_tpu/utils/
metrics_writer.py``): ``metrics.jsonl`` with one record per call, in the
JAX package's form (``{"step": N, tag: value, ...}`` for scalars,
``{"step", "histogram", "counts", "edges"}`` for histograms), and image
panels as PNGs under ``panels/iter_<step>/`` through ``data/png.py``.
The JAX writer also mirrors everything to TensorBoard when it is
installed; this one writes files only.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from splatfields_torch.data import png


class MetricsWriter:
    def __init__(self, model_path: str | None):
        self._file = None
        if model_path:
            os.makedirs(model_path, exist_ok=True)
            self._file = open(os.path.join(model_path, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: dict[str, Any]):
        if self._file is None:
            return
        rec = {"step": int(step)}
        for k, v in values.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._file.write(json.dumps(rec) + "\n")
        if step % 100 == 0:
            self._file.flush()

    def images(self, step: int, name: str, panels: dict[str, Any]):
        """[3,H,W], [1,H,W] or [H,W] float panels in [0, 1] -> RGB PNGs."""
        if self._file is None:
            return
        out_dir = os.path.join(os.path.dirname(self._file.name), "panels",
                               f"iter_{int(step)}")
        os.makedirs(out_dir, exist_ok=True)
        for tag, img in panels.items():
            arr = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
            if arr.ndim == 3 and arr.shape[0] in (1, 3):
                arr = arr.transpose(1, 2, 0)
            if arr.ndim == 2:
                arr = arr[..., None]
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            png.write(os.path.join(out_dir, f"{name}_{tag}.png"),
                      (arr * 255).astype(np.uint8))

    def histogram(self, step: int, name: str, values: Any, bins: int = 64):
        if self._file is None:
            return
        vals = np.asarray(values, np.float32).reshape(-1)
        counts, edges = np.histogram(vals, bins=bins)
        rec = {"step": int(step), "histogram": name,
               "counts": counts.tolist(),
               "edges": np.round(edges, 6).tolist()}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
