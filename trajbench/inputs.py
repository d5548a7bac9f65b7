"""Inputs drawn from ``--seed``: clouds, base paths and the requests' paths.

Each purpose draws from its own stream of one ``SeedSequence`` built from
the seed (any whole number; it is taken modulo 2**64), so the same seed
gives the same inputs on any machine. The generators are the kinds a
configuration or traffic file names; a new kind is a new function here.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

STREAMS = {"cloud": 1, "moves": 2, "sample": 3}


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64),
                                                         STREAMS[purpose]]))


def _npz(spec: dict, root: Path) -> np.ndarray:
    """The array a file names, which has to hold the ``n`` rows the
    configuration states."""
    a = np.load(root / spec["file"])[spec["key"]].astype(np.float32)
    if len(a) != int(spec["n"]):
        raise ValueError(f"{spec['file']} holds {len(a)} rows, the configuration states {spec['n']}")
    return a


def cloud(spec: dict, seed: int, root: Path) -> np.ndarray:
    """(N, 3) float32 points."""
    if spec["kind"] == "npz":
        return _npz(spec, root)
    if spec["kind"] == "uniform":
        h = float(spec["half_extent_m"])
        return rng(seed, "cloud").uniform(-h, h, size=(int(spec["n"]), 3)).astype(np.float32)
    raise ValueError(f"unknown cloud kind {spec['kind']!r}")


def path(spec: dict, root: Path) -> np.ndarray:
    """(W, 3) float32 waypoints of the configuration's path."""
    if spec["kind"] == "npz":
        return _npz(spec, root)
    if spec["kind"] == "sine":
        # (x_len·t, y_amp·sin(freq·t), 0), t in [0, 1]
        t = np.linspace(0, 1, int(spec["n"]), dtype=np.float32)
        return np.stack([spec["x_len_m"] * t, spec["y_amp_m"] * np.sin(spec["freq"] * t),
                         np.zeros_like(t)], axis=1).astype(np.float32)
    raise ValueError(f"unknown path kind {spec['kind']!r}")


def moved_paths(base: np.ndarray, moves: dict, seed: int) -> np.ndarray:
    """(pool, W, 3) float32: the base path turned about its centroid by a yaw
    in ±max_yaw_deg and shifted by an offset in ±max_offset_xy_m in x and y,
    one rigid move per request. A rigid move keeps every segment's length,
    so the waypoint stride and every shape stay those of the base path."""
    r = rng(seed, "moves")
    n = int(moves["pool"])
    yaw = np.radians(r.uniform(-moves["max_yaw_deg"], moves["max_yaw_deg"], n))
    off = r.uniform(-moves["max_offset_xy_m"], moves["max_offset_xy_m"], (n, 2))
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.zeros((n, 3, 3))
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1], rot[:, 2, 2] = c, -s, s, c, 1.0
    b = base.astype(np.float64)
    ctr = b.mean(axis=0)
    out = np.einsum("nij,wj->nwi", rot, b - ctr) + ctr
    out[:, :, :2] += off[:, None, :]
    return out.astype(np.float32)


def sample_order(seed: int, n: int) -> np.ndarray:
    """A seeded priority for each of ``n`` request indices: the requests
    checked are the completed ones with the lowest priorities."""
    return rng(seed, "sample").permutation(n)
