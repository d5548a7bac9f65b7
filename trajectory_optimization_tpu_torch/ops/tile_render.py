"""Tile splat renderer: tile-binned z-nearest splatting.

Twin of ``trajectory_optimization_tpu/ops/pallas_render.py``. The image is
cut into 32×128-pixel tiles; a kernel blends each tile's candidate splats
into a z-buffer and colours it holds on chip, and writes every output pixel
once. The prologue is plain PyTorch, as the JAX twin's is XLA: projection,
pixel radius, the ``ok`` mask, the (N, 8) entries
``[round(u), round(v), z, r², r, g, b, 0]``, the bins, a **stable** sort of
the bin ids with a gather of the entries, and ``searchsorted`` (left side)
for the ``n_tiles + 1`` offsets. Stability is load-bearing: the blend
breaks equal depths by scan order, so the sort keeps point order within a
bin, as the JAX twin's ``lax.sort`` does.

Two paths, chosen as the JAX twin chooses them:

* **Run path** (K6, ``splat_runs``), exact: each point is binned to ONE
  tile, the one holding its footprint's top-left corner (clamped into the
  grid). A footprint spans at most 2×2 tiles, so tile (ty, tx) scans the
  two contiguous runs of bins (ty-1, tx-1..tx) and (ty, tx-1..tx).
  ``n_dropped`` is 0.
* **Dense path** (K7, ``splat_dense``): every point is duplicated into the
  ≤2×2 tiles its footprint box touches, in the JAX copy-major layout
  ((dy, dx) = (0,0), (0,1), (1,0), (1,1), each over all points); tile t
  blends the first ``max_entries_per_tile`` entries of its stably sorted
  run and the rest are counted in ``n_dropped``. The JAX twin packs the
  kept entries into an (n_tiles, MAX_E, 8) tensor for its TPU block
  machinery; reading the run directly keeps the same entries.

``backend="auto"`` takes the run path when the (padded) point count is at
most ``RUN_PATH_MAX_ENTRIES`` = 65,536. That count is the JAX twin's TPU
VMEM budget; it is kept so that ``return_overflow`` and the images stay
those of the JAX twin.

On CPU tensors the blend runs as its plain PyTorch version
(``splat_runs_ref``, ``splat_dense_ref``); on CUDA tensors as the
hand-written kernels of ``csrc/splat_render.cu``, where each warp owns a
band of ``BAND_W`` columns of the tile and blends only the entries that
reach it (``band_cull`` is that cull, plain, for the tests).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from trajectory_optimization_tpu_torch.ops import _kernels
from trajectory_optimization_tpu_torch.ops.render import _default_colors

TILE_H = _kernels.SPLAT_TILE_H
TILE_W = _kernels.SPLAT_TILE_W
BAND_W = _kernels.SPLAT_BAND_W  # columns of a tile that one warp of the kernels owns
N_BANDS = TILE_W // BAND_W
FAR = 3.0e38  # the background depth: an entry wins a pixel only below it
RUN_PATH_MAX_ENTRIES = 65536
_REF_CHUNK = 512  # entries per step of the plain blend (bounds its memory)


def tile_grid(img_height: int, img_width: int) -> Tuple[int, int]:
    """(tiles_y, tiles_x) covering an H×W image."""
    return -(-int(img_height) // TILE_H), -(-int(img_width) // TILE_W)


_on_cpu = _kernels.on_cpu


# ---- the blend: kernels on CUDA, plain versions on CPU ---------------------


def _blend_tile_ref(cand: torch.Tensor, ty: int, tx: int, bg: float):
    """z-nearest blend of one tile's candidate entries (in scan order):
    returns (3, TILE_H, TILE_W). Coverage is ``dr² + dc² <= r²`` and an
    entry takes a pixel only at a strictly smaller depth, so among equal
    depths the first in scan order wins: ``torch.argmin`` returns the first
    minimum."""
    dev = cand.device
    rows = (ty * TILE_H + torch.arange(TILE_H, device=dev)).to(torch.float32)
    cols = (tx * TILE_W + torch.arange(TILE_W, device=dev)).to(torch.float32)
    # Entries whose footprint misses the tile cannot take a pixel of it; the
    # test is exact (integer-valued distances to the tile's pixel box).
    dc0 = torch.clamp(torch.clamp(cols[0] - cand[:, 0], min=0.0), min=cand[:, 0] - cols[-1])
    dr0 = torch.clamp(torch.clamp(rows[0] - cand[:, 1], min=0.0), min=cand[:, 1] - rows[-1])
    cand = cand[dr0 * dr0 + dc0 * dc0 <= cand[:, 3]]
    zbuf = torch.full((TILE_H, TILE_W), FAR, dtype=torch.float32, device=dev)
    rgb = torch.full((3, TILE_H, TILE_W), bg, dtype=torch.float32, device=dev)
    for c0 in range(0, cand.shape[0], _REF_CHUNK):
        e = cand[c0:c0 + _REF_CHUNK]
        dr = rows[None, :, None] - e[:, 1, None, None]
        dc = cols[None, None, :] - e[:, 0, None, None]
        covered = dr * dr + dc * dc <= e[:, 3, None, None]
        zc = torch.where(covered, e[:, 2, None, None], torch.inf)
        k = torch.argmin(zc, dim=0)  # first minimum: the earliest entry of equal depth
        zmin = torch.gather(zc, 0, k[None])[0]
        take = zmin < zbuf  # strict: an earlier chunk keeps equal depths
        zbuf = torch.where(take, zmin, zbuf)
        rgb = torch.where(take[None], e[k, 4:7].permute(2, 0, 1), rgb)
    return rgb


def tile_runs(offsets, tiles_y: int, tiles_x: int, max_e: Optional[int] = None):
    """Each tile's (lo, hi) entry ranges, in scan order. K6 (``max_e`` None):
    the runs of bins (ty-1, tx-1..tx) (when ty ≥ 1), then (ty, tx-1..tx).
    K7: the first ``max_e`` entries of the tile's own run."""
    off = offsets.cpu().tolist()
    if max_e is not None:
        return [[(off[t], off[t] + min(off[t + 1] - off[t], max_e))]
                for t in range(tiles_y * tiles_x)]
    runs = []
    for t in range(tiles_y * tiles_x):
        ty, tx = divmod(t, tiles_x)
        c_lo = max(tx - 1, 0)
        runs.append([(off[row * tiles_x + c_lo], off[row * tiles_x + tx + 1])
                     for row in (ty - 1, ty) if row >= 0])
    return runs


def tile_candidates(entries, runs, t: int) -> torch.Tensor:
    """Tile t's candidate entries (n, 8), in scan order."""
    return torch.cat([entries[lo:hi] for lo, hi in runs[t]])


def _blend_ref(runs, entries, tiles_y, tiles_x, bg):
    """Apply ``_blend_tile_ref`` to every tile. Returns (3, Hp, Wp)."""
    out = torch.empty((3, tiles_y * TILE_H, tiles_x * TILE_W), dtype=torch.float32,
                      device=entries.device)
    for t in range(tiles_y * tiles_x):
        ty, tx = divmod(t, tiles_x)
        out[:, ty * TILE_H:(ty + 1) * TILE_H, tx * TILE_W:(tx + 1) * TILE_W] = (
            _blend_tile_ref(tile_candidates(entries, runs, t), ty, tx, bg))
    return out


def splat_runs_ref(offsets, entries, tiles_y: int, tiles_x: int, bg: float):
    """Plain K6: each tile blends the runs of bins (ty-1, tx-1..tx) (when
    ty ≥ 1), then (ty, tx-1..tx)."""
    return _blend_ref(tile_runs(offsets, tiles_y, tiles_x), entries, tiles_y, tiles_x, bg)


def splat_dense_ref(offsets, entries, max_e: int, tiles_y: int, tiles_x: int, bg: float):
    """Plain K7: tile t blends the first ``max_e`` entries of its run."""
    return _blend_ref(tile_runs(offsets, tiles_y, tiles_x, max_e), entries, tiles_y, tiles_x,
                      bg)


def band_cull(cand: torch.Tensor, ty: int, tx: int):
    """The kernels' cull, plain (nothing on the card path uses it). Tile
    (ty, tx) is cut into ``N_BANDS`` bands of ``BAND_W`` columns, one warp
    each; for the tile's candidates (n, 8) returns ``keep`` (N_BANDS, n)
    bool, the entries whose footprint reaches a pixel of the band (the
    distance (dr0, dc0) from (u, v) to the band's pixel box has
    dr0² + dc0² ≤ r²), and ``box`` (N_BANDS, n, 4) int64, the image columns
    [c_lo, c_hi] and rows [r_lo, r_hi] that a kept entry's blend visits:
    (u, v) ± floor(sqrt(r²)), clipped to the band. For the prologue's
    entries (integer-valued u, v) ``keep`` is exact and no covered pixel
    lies outside ``box``."""
    u, v, r2 = cand[:, 0], cand[:, 1], cand[:, 3]
    x0 = (tx * TILE_W + BAND_W * torch.arange(N_BANDS, device=cand.device)).to(torch.float32)
    x0 = x0[:, None]
    x1 = x0 + (BAND_W - 1)
    y0, y1 = float(ty * TILE_H), float(ty * TILE_H + TILE_H - 1)
    dc0 = torch.maximum(torch.clamp(x0 - u, min=0.0), u - x1)
    dr0 = torch.clamp(torch.clamp(y0 - v, min=0.0), min=v - y1)
    s = torch.floor(torch.sqrt(r2))
    c_lo, c_hi = torch.maximum(u - s, x0), torch.minimum(u + s, x1)
    r_lo = torch.clamp(v - s, min=y0).expand_as(c_lo)
    r_hi = torch.clamp(v + s, max=y1).expand_as(c_lo)
    keep = (dr0 * dr0 + dc0 * dc0 <= r2) & (c_hi >= c_lo) & (r_hi >= r_lo)
    return keep, torch.stack([c_lo, c_hi, r_lo, r_hi], dim=-1).long()


def splat_runs(offsets, entries, tiles_y: int, tiles_x: int, bg: float):
    """K6 on CUDA tensors, its plain version on CPU tensors: (3, Hp, Wp)."""
    if _on_cpu(entries):
        return splat_runs_ref(offsets, entries, tiles_y, tiles_x, bg)
    return _kernels.splat_runs(offsets, entries, tiles_y, tiles_x, bg)


def splat_dense(offsets, entries, max_e: int, tiles_y: int, tiles_x: int, bg: float):
    """K7 on CUDA tensors, its plain version on CPU tensors: (3, Hp, Wp)."""
    if _on_cpu(entries):
        return splat_dense_ref(offsets, entries, max_e, tiles_y, tiles_x, bg)
    return _kernels.splat_dense(offsets, entries, max_e, tiles_y, tiles_x, bg)


# ---- the prologue ----------------------------------------------------------


def _offsets(sorted_ids: torch.Tensor, n_tiles: int) -> torch.Tensor:
    bins = torch.arange(n_tiles + 1, dtype=sorted_ids.dtype, device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, bins, side="left").to(torch.int32)


def splat_prologue(
    cam_points: torch.Tensor,
    K: torch.Tensor,
    img_height: int,
    img_width: int,
    *,
    colors: Optional[torch.Tensor] = None,
    point_radius: float = 0.03,
    znear: float = 1.0,
    zfar: float = 10.0,
    max_radius_px: int = 4,
    valid: Optional[torch.Tensor] = None,
    max_entries_per_tile: int = 2048,
    backend: str = "auto",
):
    """Everything before the blend. Returns ``(use_runs, offsets, sorted
    entries, n_dropped)``: offsets (n_tiles + 1,) int32 into the stably
    sorted entries, and n_dropped the entries the dense path's per-tile cap
    discards (a 0-d int64 tensor, 0 on the run path)."""
    if backend not in ("auto", "runs", "dense"):
        raise ValueError(f"unknown renderer backend {backend!r}")
    H, W = int(img_height), int(img_width)
    if H <= 0 or W <= 0:
        raise ValueError(f"image size must be positive, got {H}x{W}")
    tiles_y, tiles_x = tile_grid(H, W)
    n_tiles = tiles_y * tiles_x
    dev = cam_points.device
    n = cam_points.shape[0]

    x, y, z = cam_points[:, 0], cam_points[:, 1], cam_points[:, 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if colors is None:
        colors = _default_colors(cam_points, valid) if n else cam_points
    zs = torch.clamp(z, min=1e-6)
    u = fx * x / zs + cx
    v = fy * y / zs + cy
    r_px = torch.clamp(torch.clamp(point_radius * fx / zs, max=float(max_radius_px)), min=0.5)

    ok = (z > znear) & (z < zfar)
    ok = ok & (u > -r_px) & (u < W + r_px) & (v > -r_px) & (v < H + r_px)
    if valid is not None:
        ok = ok & (valid > 0)

    # splat around the rounded pixel centre (round half to even, as
    # jnp.round); +1 px guard on the footprint box for that rounding
    entries = torch.stack(
        [torch.round(u), torch.round(v), z, torch.square(r_px),
         colors[:, 0], colors[:, 1], colors[:, 2], torch.zeros_like(u)],
        dim=1,
    ).to(torch.float32).contiguous()
    rb = r_px + 1.0
    # tile rows/columns of the footprint box's corner, kept in float (a true
    # division, as in JAX); points off ``ok`` are binned past the grid
    ty0 = torch.floor((v - rb) / TILE_H)
    tx0 = torch.floor((u - rb) / TILE_W)

    use_runs = backend == "runs" or (backend == "auto" and n <= RUN_PATH_MAX_ENTRIES)
    if use_runs:
        ty0c = torch.clamp(ty0, 0, tiles_y - 1)
        tx0c = torch.clamp(tx0, 0, tiles_x - 1)
        home = torch.where(ok, ty0c * tiles_x + tx0c, float(n_tiles)).to(torch.int32)
        sorted_ids, perm = torch.sort(home, stable=True)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return True, _offsets(sorted_ids, n_tiles), entries[perm], zero

    ids = []
    for dy in (0, 1):
        for dx in (0, 1):
            ty, tx = ty0 + dy, tx0 + dx
            hit = (
                ok
                & (ty >= 0) & (ty < tiles_y) & (tx >= 0) & (tx < tiles_x)
                & (v + rb >= ty * TILE_H) & (v - rb < (ty + 1) * TILE_H)
                & (u + rb >= tx * TILE_W) & (u - rb < (tx + 1) * TILE_W)
            )
            ids.append(torch.where(hit, ty * tiles_x + tx, float(n_tiles)).to(torch.int32))
    sorted_ids, perm = torch.sort(torch.cat(ids), stable=True)  # (4N,), copy-major
    offsets = _offsets(sorted_ids, n_tiles)
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    n_dropped = torch.sum(torch.clamp(counts - int(max_entries_per_tile), min=0))
    return False, offsets, entries[perm % max(n, 1)], n_dropped


def render_point_cloud_tiles(
    cam_points: torch.Tensor,
    K: torch.Tensor,
    img_height: int,
    img_width: int,
    *,
    colors: Optional[torch.Tensor] = None,
    point_radius: float = 0.03,
    znear: float = 1.0,
    zfar: float = 10.0,
    bg_color: float = 1.0,
    max_radius_px: int = 4,
    valid: Optional[torch.Tensor] = None,
    max_entries_per_tile: int = 2048,
    return_overflow: bool = False,
    backend: str = "auto",
):
    """Render camera-frame points (N, 3) to an (H, W, 3) image, with the
    signature of ``render_point_cloud_pallas``.

    With ``return_overflow=True`` returns (image, n_dropped): the entries
    the dense path's ``max_entries_per_tile`` cap discarded (0 means the
    render is exact; the run path always is). ``backend``: 'auto' takes the
    run path up to ``RUN_PATH_MAX_ENTRIES`` points, else the dense path;
    'runs' / 'dense' force one.
    """
    H, W = int(img_height), int(img_width)
    tiles_y, tiles_x = tile_grid(H, W)
    use_runs, offsets, entries, n_dropped = splat_prologue(
        cam_points, K, H, W, colors=colors, point_radius=point_radius, znear=znear,
        zfar=zfar, max_radius_px=max_radius_px, valid=valid,
        max_entries_per_tile=max_entries_per_tile, backend=backend,
    )
    if use_runs:
        planes = splat_runs(offsets, entries, tiles_y, tiles_x, float(bg_color))
    else:
        planes = splat_dense(offsets, entries, int(max_entries_per_tile), tiles_y, tiles_x,
                             float(bg_color))
    img = planes[:, :H, :W].permute(1, 2, 0).contiguous()
    if return_overflow:
        return img, n_dropped
    return img
