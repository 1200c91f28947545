"""Calibrated edge-backend selection for ``EngineConfig.edge_backend='auto'``.

The three edge-compute backends trade memory traffic very differently:

  - ``coo``            pays ~24 bytes per resident edge (gather + scatter)
                       plus a dense per-vertex aggregate;
  - ``pallas_tiles``   pays a fixed ~64 KiB per 128x128 tile however empty
                       it is — a coverage floor of ``n_dst_tiles`` tiles even
                       for a near-empty partition;
  - ``pallas_windows`` pays per occupied 512-edge block (~8 bytes/slot) plus
                       a per-window epilogue.

The crossover points are machine properties, so ``'auto'`` derives them
from a small **calibration sweep** run once per platform and cached on
disk: synthetic single-partition adjacencies spanning a tile-density grid
go through the engine's own geometry builders (``core/layouts.py``), each
point is costed per backend, and per-unit costs (seconds per COO edge, per
dense tile, per window block, ...) are fitted by least squares. This is the
JAX package's design (``repro.core.autotune``), grid, schema and tie-break
included:

  - **measured**, on a CUDA device: each point's three paths are timed on
    the card with CUDA events — the COO gather plus ``scatter_reduce_``,
    ``bsp_spmv`` on the point's compact tile list, the message buffer plus
    ``segment_combine_windowed`` on its block list — best of
    ``MEASURE_RUNS`` after a warm-up launch;
  - **modeled**, on the CPU: the byte accounting of a roofline at the H100's
    nominal memory rate (``HBM_BYTES_PER_S``). A uniform rate scales every
    cost alike, so the modeled picks are the JAX package's modeled picks.

The platform string comes from torch: ``"torch-cpu"``, or
``"torch-cuda-sm<major><minor>-<device name>"`` on a card. It names the
cache file, so no table of another platform — nor of the JAX package,
whose files are ``autotune_<jax backend>_v1.json`` — is ever loaded.

The policy is a pure argmin over per-partition unit counts the layout
geometry already tracks (``edges_per_part``, ``EdgeLayouts.n_tiles``,
``EdgeLayouts.n_blocks``): no device work, the same answer for the same
geometry. ``engine.resolve_partition_backends`` is the engine-facing entry;
sessions pin the resulting assignment per shape bucket.

Cache location: ``$DRONE_AUTOTUNE_DIR`` when set, else ``~/.cache/drone/``,
one JSON per (platform, schema version). A corrupt or stale-schema file is
recalibrated, never trusted. The processes of a job share the directory
and calibrate at once on first use, so each writes its own temporary file
and moves it into place: a reader sees one whole table, and no writer
loses its file to another's move.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import unique_sorted
from repro_torch.core.layouts import (DEFAULT_BLOCK_EDGES, _tile_geometry,
                                      _window_geometry)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bsp_spmv import TM, TN
from repro_torch.kernels.segment_combine import W

__all__ = ["CalibrationTable", "calibrate", "get_table", "load_table",
           "save_table", "table_path", "pick_backends", "platform_name",
           "BACKEND_ORDER", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1

#: argmin tie-break order — fixed so replayed tables pick identically.
BACKEND_ORDER: Tuple[str, ...] = ("coo", "pallas_windows", "pallas_tiles")

#: the modeled path's uniform memory rate: the H100 SXM's nominal HBM3 rate
HBM_BYTES_PER_S = 3.35e12
#: timed runs per point and backend on the measured path (after a warm-up)
MEASURE_RUNS = 3

#: calibration grid: (n_vertices, target tile density) pairs. Two vertex
#: counts make the COO per-edge/per-vertex costs separately identifiable;
#: the density axis spans the ultra-sparse -> dense crossover region.
GRID_NV: Tuple[int, ...] = (256, 512)
GRID_DENSITY: Tuple[float, ...] = (0.0005, 0.002, 0.01, 0.05, 0.2, 0.6)
_GRID_SEED = 0xD120


# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class CalibrationTable:
    """One platform's calibrated per-unit backend costs + the sweep points
    they were fitted from (same platform, same schema => byte-identical
    JSON on the modeled path)."""

    platform: str
    source: str                       # 'modeled' | 'measured'
    points: list                      # list of per-point dicts (JSON rows)
    unit_costs: Dict[str, float]      # seconds per unit of work

    def partition_costs(self, *, n_edges, n_vertices: int, n_tiles,
                        n_blocks, n_windows: int) -> Dict[str, np.ndarray]:
        """Predicted per-partition sweep cost (seconds) per backend.

        ``n_edges``/``n_tiles``/``n_blocks`` are [P] unit counts from the
        graph and its ``EdgeLayouts`` geometry; ``n_vertices`` and
        ``n_windows`` are the shared padded per-partition constants."""
        u = self.unit_costs
        ne = np.asarray(n_edges, np.float64)
        coo = u["coo_edge"] * ne + u["coo_vertex"] * float(n_vertices)
        tiles = u["tile"] * np.asarray(n_tiles, np.float64)
        windows = (u["win_block"] * np.asarray(n_blocks, np.float64)
                   + u["win_window"] * float(n_windows)
                   + u["win_edge"] * ne)
        return {"coo": coo, "pallas_tiles": tiles, "pallas_windows": windows}

    def pick(self, *, n_edges, n_vertices: int, n_tiles, n_blocks,
             n_windows: int) -> Tuple[str, ...]:
        """Per-partition argmin over ``partition_costs`` (ties resolve to
        the earliest entry of ``BACKEND_ORDER``)."""
        costs = self.partition_costs(
            n_edges=n_edges, n_vertices=n_vertices, n_tiles=n_tiles,
            n_blocks=n_blocks, n_windows=n_windows)
        mat = np.stack([np.atleast_1d(costs[b]) for b in BACKEND_ORDER])
        return tuple(BACKEND_ORDER[i] for i in np.argmin(mat, axis=0))

    def to_json(self) -> str:
        return json.dumps(
            dict(version=SCHEMA_VERSION, platform=self.platform,
                 source=self.source, unit_costs=self.unit_costs,
                 points=self.points),
            indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationTable":
        d = json.loads(text)
        if d.get("version") != SCHEMA_VERSION:
            raise ValueError(f"autotune table schema {d.get('version')!r} != "
                             f"{SCHEMA_VERSION}")
        return cls(platform=d["platform"], source=d["source"],
                   points=d["points"], unit_costs=d["unit_costs"])


# --------------------------------------------------------------------------- #
# calibration sweep
# --------------------------------------------------------------------------- #
def _synthetic_edges(nv: int, density: float,
                     seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A deterministic single-partition adjacency with ~``density``
    occupancy of the nv x nv grid, dst-sorted ascending like
    ``localize_edges`` output."""
    rng = np.random.default_rng(seed)
    ne = int(np.clip(round(density * nv * nv), 1, nv * nv))
    flat = rng.choice(nv * nv, size=ne, replace=False)
    dst, src = flat // nv, flat % nv
    order = np.lexsort((src, dst))
    return src[order].astype(np.int64), dst[order].astype(np.int64)


def _point_units(nv: int, src: np.ndarray, dst: np.ndarray) -> dict:
    """Unit counts the engine's geometry builders would assign this
    adjacency (coverage fillers and per-window block minima included)."""
    ndt = max(-(-nv // TM), 1)
    nst = max(-(-nv // TN), 1)
    nw = max(-(-nv // W), 1)
    td, _ts, _et, _er, _ec = _tile_geometry(src, dst, ndt, nst)
    _es, _ld, _bw, nb = _window_geometry(dst, nw, DEFAULT_BLOCK_EDGES)
    filled = unique_sorted(dst * np.int64(nv) + src).shape[0]
    return dict(n_vertices=int(nv), n_edges=int(src.shape[0]),
                n_tiles=int(td.shape[0]), n_blocks=int(nb),
                n_windows=int(nw),
                density=filled / float(td.shape[0] * TM * TN))


def _modeled_costs(units: dict) -> Dict[str, float]:
    """Roofline-modeled sweep time per backend (K=1): COO streams ~24 B per
    edge + 8 B per vertex row; a dense tile streams its values + the v/out
    slices; a window block streams its slot buffer + the per-window
    epilogue, and every edge pays the int32 slot read + f32 message."""
    ne, nv = units["n_edges"], units["n_vertices"]
    bw = HBM_BYTES_PER_S
    coo = (ne * 24.0 + nv * 8.0) / bw
    tiles = units["n_tiles"] * (TM * TN * 4.0 + (TM + TN) * 4.0) / bw
    windows = (units["n_blocks"] * DEFAULT_BLOCK_EDGES * 8.0
               + units["n_windows"] * W * 8.0 + ne * 8.0) / bw
    return {"coo": coo, "pallas_tiles": tiles, "pallas_windows": windows}


def _measured_costs(units: dict, src: np.ndarray, dst: np.ndarray,
                    device) -> Dict[str, float]:
    """Seconds of one K = 1 min_plus sweep of this adjacency on each of the
    engine's three paths, timed on the CUDA ``device`` with CUDA events:
    best of ``MEASURE_RUNS`` after a warm-up launch."""
    import torch

    from repro_torch.kernels.bsp_spmv import bsp_spmv, plan_tiles
    from repro_torch.kernels.segment_combine import (plan_windows,
                                                     segment_combine_windowed)

    dev = torch.device(device)
    nv, ne = units["n_vertices"], units["n_edges"]
    ndt = max(-(-nv // TM), 1)
    nst = max(-(-nv // TN), 1)
    nw = max(-(-nv // W), 1)
    Be = DEFAULT_BLOCK_EDGES
    td, ts, et, er, ec = _tile_geometry(src, dst, ndt, nst)
    tiles = np.full((td.shape[0], TM, TN), np.inf, np.float32)
    np.minimum.at(tiles, (et, er, ec), np.float32(1.0))
    es, ldst, bwin, nb = _window_geometry(dst, nw, Be)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    inf = float("inf")
    v = torch.linspace(0.0, 1.0, nv, dtype=torch.float32, device=dev)
    s, d = t(src), t(dst)
    w = torch.ones(ne, dtype=torch.float32, device=dev)
    tiles_t, td_t, ts_t = t(tiles), t(td), t(ts)
    tplan = plan_tiles(td_t, ndt)
    ldst_t, bwin_t, slot = t(ldst), t(bwin), t(es.astype(np.int64))
    wplan = plan_windows(bwin_t, nw)

    def coo_fn():
        agg = torch.full((nv,), inf, dtype=torch.float32, device=dev)
        return agg.scatter_reduce_(0, d, v[s] + w, "amin", include_self=True)

    def tiles_fn():
        vv = torch.full((nst * TN, 1), inf, dtype=torch.float32, device=dev)
        vv[:nv, 0] = v
        return bsp_spmv(tiles_t, td_t, ts_t, vv.reshape(nst, TN, 1),
                        n_dst_tiles=ndt, semiring="min_plus", plan=tplan)

    def windows_fn():
        buf = torch.full((nb * Be, 1), inf, dtype=torch.float32, device=dev)
        buf.index_copy_(0, slot, (v[s] + w)[:, None])
        return segment_combine_windowed(buf, ldst_t, bwin_t, n_windows=nw,
                                        combiner="min", plan=wplan)

    def timed(fn) -> float:
        fn()                                       # build + warm
        torch.cuda.synchronize(dev)
        best = np.inf
        for _ in range(MEASURE_RUNS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        return float(best)

    return {"coo": timed(coo_fn), "pallas_tiles": timed(tiles_fn),
            "pallas_windows": timed(windows_fn)}


def _fit_unit_costs(points: Sequence[dict]) -> Dict[str, float]:
    """Least-squares per-unit costs from the sweep points. On the modeled
    path the regression is exact (the costs are linear in the unit
    counts); on the measured path it smooths launch noise. Coefficients are
    clipped at >= 0 so one noisy point can never invert a cost."""
    def fit(cols: np.ndarray, y: np.ndarray) -> np.ndarray:
        coef, *_ = np.linalg.lstsq(cols, y, rcond=None)
        return np.maximum(coef, 0.0)

    ne = np.array([p["n_edges"] for p in points], np.float64)
    nv = np.array([p["n_vertices"] for p in points], np.float64)
    nt = np.array([p["n_tiles"] for p in points], np.float64)
    nb = np.array([p["n_blocks"] for p in points], np.float64)
    nw = np.array([p["n_windows"] for p in points], np.float64)

    c_coo = fit(np.stack([ne, nv], 1),
                np.array([p["cost_coo"] for p in points]))
    c_tile = fit(nt[:, None], np.array([p["cost_tiles"] for p in points]))
    c_win = fit(np.stack([nb, nw, ne], 1),
                np.array([p["cost_windows"] for p in points]))
    return {"coo_edge": float(c_coo[0]), "coo_vertex": float(c_coo[1]),
            "tile": float(c_tile[0]), "win_block": float(c_win[0]),
            "win_window": float(c_win[1]), "win_edge": float(c_win[2])}


def platform_name(device: DeviceLike = None) -> str:
    """The calibration platform of ``device`` (``None``: the CUDA card):
    ``"torch-cpu"`` or ``"torch-cuda-sm<major><minor>-<device name>"``."""
    import torch
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"torch-{dev.type}"
    major, minor = torch.cuda.get_device_capability(dev)
    name = re.sub(r"[^A-Za-z0-9]+", "-",
                  torch.cuda.get_device_name(dev)).strip("-")
    return f"torch-cuda-sm{major}{minor}-{name}"


def _is_measured(platform: str) -> bool:
    return platform.startswith("torch-cuda")


def calibrate(platform: Optional[str] = None, *,
              device: DeviceLike = None) -> CalibrationTable:
    """Run the calibration sweep for ``platform`` (default: that of
    ``device``). A CUDA platform is timed on ``device`` (default: the CUDA
    card); any other is modeled, pure host work."""
    platform = platform or platform_name(device)
    measured = _is_measured(platform)
    dev = None
    if measured:
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"platform {platform!r} is timed on a CUDA "
                             f"device, got {dev}")
    points = []
    for i, nv in enumerate(GRID_NV):
        for j, density in enumerate(GRID_DENSITY):
            src, dst = _synthetic_edges(nv, density,
                                        _GRID_SEED + 97 * i + j)
            units = _point_units(nv, src, dst)
            costs = _measured_costs(units, src, dst, dev) if measured \
                else _modeled_costs(units)
            points.append(dict(units, cost_coo=costs["coo"],
                               cost_tiles=costs["pallas_tiles"],
                               cost_windows=costs["pallas_windows"]))
    return CalibrationTable(platform=platform,
                            source="measured" if measured else "modeled",
                            points=points,
                            unit_costs=_fit_unit_costs(points))


# --------------------------------------------------------------------------- #
# disk cache
# --------------------------------------------------------------------------- #
def cache_dir() -> str:
    return os.environ.get("DRONE_AUTOTUNE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "drone")


def table_path(platform: Optional[str] = None) -> str:
    return os.path.join(cache_dir(),
                        f"autotune_{platform or platform_name()}"
                        f"_v{SCHEMA_VERSION}.json")


def load_table(platform: Optional[str] = None
               ) -> Optional[CalibrationTable]:
    path = table_path(platform)
    try:
        with open(path, "r", encoding="utf-8") as f:
            return CalibrationTable.from_json(f.read())
    except FileNotFoundError:
        return None
    except (ValueError, KeyError) as e:
        # stale schema / corrupt cache: recalibrate rather than trust it
        logging.getLogger(__name__).debug(
            "discarding autotune cache %s: %s", path, e)
        return None


def save_table(table: CalibrationTable) -> str:
    path = table_path(table.platform)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tempfile.NamedTemporaryFile(
            "w", encoding="utf-8", dir=os.path.dirname(path),
            prefix=os.path.basename(path) + ".", suffix=".tmp",
            delete=False) as f:
        f.write(table.to_json())
    os.replace(f.name, path)
    return path


def get_table(platform: Optional[str] = None, *, force: bool = False,
              device: DeviceLike = None) -> CalibrationTable:
    """The platform's calibration table: disk cache first, else calibrate
    and persist. ``force=True`` recalibrates unconditionally."""
    platform = platform or platform_name(device)
    if not force:
        cached = load_table(platform)
        if cached is not None:
            return cached
    table = calibrate(platform, device=device)
    save_table(table)
    return table


# --------------------------------------------------------------------------- #
def pick_backends(table: CalibrationTable, pg, lay) -> Tuple[str, ...]:
    """Per-partition backend assignment for a ``PartitionedGraph`` + its
    ``EdgeLayouts`` geometry — the ``edge_backend='auto'`` policy."""
    return table.pick(
        n_edges=pg.edges_per_part, n_vertices=pg.v_max,
        n_tiles=lay.n_tiles, n_blocks=lay.n_blocks,
        n_windows=lay.n_windows)
