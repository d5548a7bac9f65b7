"""Rank programs of the port's parallel-layer tests
(``tests/test_torch_parallel*.py``).

``start(name, world, out)`` spawns ``world`` CPU ranks over gloo (the spawn
start method, ``127.0.0.1`` and a free port, torch on one thread); each runs
the function ``name`` of this module with its rank and saves the returned
arrays to ``out/rank<r>.npz``; ``finish`` waits for them and loads the
arrays, raising if any rank failed. This module imports torch, numpy and the
port only, so the ranks never load JAX.

Each rank program builds the meshes of one file in the same order on every
rank (``make_mesh`` is collective): ``d1`` (rank 0 alone), ``d2``, ``d4``
and the 2×2 ``m22`` of a 4-rank world; a rank outside a mesh skips its
work. Keys are ``<mesh>/<name>``; per-rank slices are assembled by the test.
"""
import os
import socket
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the ranks import the port from the checkout
    sys.path.insert(0, str(ROOT))
MESHES = (("d1", 1, 1), ("d2", 2, 1), ("d4", 4, 1), ("m22", 4, 2))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, name, world, port, out, kw):
    torch.set_num_threads(1)
    if name == "multihost_checks":  # starts the world itself, as a user would
        kw = dict(kw, port=port, world=world)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
    try:
        res = globals()[name](rank, **kw)
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(name, world, out, **kw):
    """Spawn the ranks of ``name`` without waiting for them."""
    os.makedirs(out, exist_ok=True)
    return mp.start_processes(_entry, args=(name, world, free_port(), str(out), kw),
                              nprocs=world, join=False, start_method="spawn")


def finish(ctx, world, out, timeout=240.0):
    """Wait for the ranks (raising if one failed or time ran out) and load
    each rank's arrays."""
    deadline = time.monotonic() + timeout
    while not ctx.join(1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(world)]


def meshes():
    """The four meshes of a 4-rank world, on CPU ranks."""
    from trajectory_optimization_tpu_torch.parallel.mesh import make_mesh
    return {key: make_mesh(n, wps=w, devices=["cpu"] * 4) for key, n, w in MESHES}


def cloud10():
    return np.load(ROOT / "data" / "points" / "point_cloud_10.npz")["pts"].astype(np.float32)


def path10():
    return np.load(ROOT / "data" / "paths" / "path_poses_10.npz")["poses"].astype(np.float32)


def pallas_inputs():
    """8,192 points of cloud 10 (a multiple of 8·128·4), 8 waypoints with
    every third rotated, and a seeded cotangent."""
    pts = cloud10()[::4][:8192]
    q = np.zeros((8, 4), np.float32)
    q[:, 0] = 1.0
    q[::3] = [0.9, 0.1, -0.3, 0.2]
    g = np.random.default_rng(0).normal(size=len(pts)).astype(np.float32)
    return pts, q, path10()[:8], g


def train_inputs():
    """Cloud 10 every 4th point padded to a multiple of 4,096, path 10 with
    every third orientation tilted."""
    from trajectory_optimization_tpu_torch.utils.data import pad_points
    padded, valid = pad_points(cloud10()[::4], multiple=4096)
    path = path10()
    q = np.zeros((len(path), 4), np.float32)
    q[:, 0] = 1.0
    q[::3] = [0.98, 0.0, 0.0, 0.2]
    return padded, valid, path, q / np.linalg.norm(q, axis=1, keepdims=True)


TRAIN_STEPS = 5


# ---------------------------------------------------------------------------
# test_torch_parallel.py: mesh, sharded_pallas, sharded
# ---------------------------------------------------------------------------


def _lo_and_grads(fn, q, t, loss_of):
    qq = torch.tensor(q, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    lo = fn(qq, tt)
    dq, dt = torch.autograd.grad(loss_of(lo), [qq, tt])
    return lo.detach(), dq, dt


def _train(step_fn, init_fn, params, *args):
    opt = init_fn(params)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, opt, loss, _ = step_fn(params, opt, *args)
        losses.append(float(loss))
    return np.asarray(losses), params


def pallas_checks(rank):
    from trajectory_optimization_tpu_torch.models.traj import TrajProblem, init_traj_params, traj_forward
    from trajectory_optimization_tpu_torch.ops import fused_vis as fv
    from trajectory_optimization_tpu_torch.opt.engine import (
        OptimizerConfig, apply_updates, make_optimizer, value_and_grad)
    from trajectory_optimization_tpu_torch.parallel.mesh import all_reduce, make_mesh
    from trajectory_optimization_tpu_torch.parallel.sharded import (
        make_sharded_train_step, shard_points, shardmap_visibility)
    from trajectory_optimization_tpu_torch.parallel.sharded_pallas import sharded_fused_lo_sum
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    intr = default_intrinsics()
    K = intr.matrix()
    out = {}
    ms = meshes()
    try:
        make_mesh(3, wps=2, devices=["cpu"] * 4)
    except ValueError as e:
        out["reject/make_mesh"] = np.asarray("not divisible by wps=2" in str(e))

    pts, q, t, g = pallas_inputs()
    budget = fv.SCORE_CACHE_MAX_BYTES
    for regime, cap_bytes in (("cached", budget), ("uncached", 0)):
        fv.SCORE_CACHE_MAX_BYTES = cap_bytes
        for key, mesh in ms.items():
            if not mesh.member:
                continue
            P, gl = shard_points(mesh, pts, g)
            lo, dq, dt = _lo_and_grads(
                lambda qq, tt: sharded_fused_lo_sum(mesh, P, qq, tt, K, intr.width, intr.height),
                q, t, lambda lo: all_reduce(torch.sum(lo * gl), mesh, "pts"))
            out.update({f"{key}/{regime}/lo": lo, f"{key}/{regime}/dq": dq,
                        f"{key}/{regime}/dt": dt})
        if rank == 0:
            Pt, gt = torch.as_tensor(pts), torch.as_tensor(g)
            lo, dq, dt = _lo_and_grads(
                lambda qq, tt: fv.fused_lo_sum(Pt, qq, tt, K, intr.width, intr.height),
                q, t, lambda lo: torch.sum(lo * gt))
            out.update({f"single/{regime}/lo": lo, f"single/{regime}/dq": dq,
                        f"single/{regime}/dt": dt})
    fv.SCORE_CACHE_MAX_BYTES = budget

    padded, valid, path, quats = train_inputs()
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    for backend in ("pallas", "xla"):
        prob = TrajProblem(img_width=intr.width, img_height=intr.height, wps_step=2,
                           backend=backend)
        poses0, quats0 = torch.as_tensor(path), torch.as_tensor(quats)
        for key, mesh in ms.items():
            if not mesh.member:
                continue
            P, V = shard_points(mesh, padded, valid)
            init_fn, step_fn = make_sharded_train_step(mesh, prob, cfg)
            losses, params = _train(step_fn, init_fn, init_traj_params(path, quats), P, V, K,
                                    poses0, quats0)
            out.update({f"{key}/{backend}/losses": losses,
                        f"{key}/{backend}/poses": params["poses"],
                        f"{key}/{backend}/quats": params["quats"]})
            if backend == "xla":
                out[f"{key}/rewards"] = shardmap_visibility(
                    mesh, P, V, torch.as_tensor(quats), poses0, K, prob)
        if rank == 0:
            tx = make_optimizer(cfg)
            params = init_traj_params(path, quats)
            opt = tx.init(params)
            Pt, Vt = torch.as_tensor(padded), torch.as_tensor(valid)
            kprob = TrajProblem(img_width=intr.width, img_height=intr.height, wps_step=2,
                                backend="kernel" if backend == "pallas" else "torch")
            losses = []
            for _ in range(TRAIN_STEPS):
                loss, _, grads = value_and_grad(
                    lambda p: traj_forward(p, Pt, K, poses0, quats0, kprob, valid=Vt), params)
                updates, opt = tx.update(grads, opt, params)
                params = apply_updates(params, updates)
                losses.append(float(loss))
            out.update({f"single/{backend}/losses": np.asarray(losses),
                        f"single/{backend}/poses": params["poses"],
                        f"single/{backend}/quats": params["quats"]})
            if backend == "xla":
                out["single/rewards"] = traj_forward(
                    init_traj_params(path, quats), Pt, K, poses0, quats0, kprob,
                    valid=Vt)[1]["rewards"].detach()
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# test_torch_parallel_hpr.py: hpr_sharded, pose_sharded, wps_sharded
# ---------------------------------------------------------------------------


def _grid_plane(n, axis, value, span1, span2, jitter=0.0, seed=0):
    rng = np.random.default_rng(seed)
    g1, g2 = np.meshgrid(np.linspace(*span1, n, dtype=np.float32),
                         np.linspace(*span2, n, dtype=np.float32))
    flat = np.stack([g1.ravel(), g2.ravel()], axis=1)
    if jitter:
        flat = flat + rng.normal(scale=jitter, size=flat.shape).astype(np.float32)
    return np.insert(flat, axis, np.float32(value), axis=1).astype(np.float32)


def room_scene():
    """The closed room of tests/test_torch_hpr_binned.py (3,681 points): from
    inside it no point is alone in its direction bin, so the JAX binned tier
    is an exact reference."""
    faces = [_grid_plane(24, axis, value, (-6, 6), (-6, 6), jitter=0.05, seed=i)
             for i, (axis, value) in enumerate(
                 [(0, -6.0), (0, 6.0), (1, -6.0), (1, 6.0), (2, -6.0), (2, 6.0)])]
    faces.append(_grid_plane(15, 2, 3.0, (-1.5, 1.5), (-1.5, 1.5), jitter=0.01, seed=9))
    return np.vstack(faces)


def room_path():
    return np.stack([np.linspace(-2.4, 2.4, 7), np.linspace(-0.8, 0.8, 7),
                     np.zeros(7)], axis=1).astype(np.float32)


def hpr_inputs():
    """The room padded to 4,096 points (valid mask), the camera at the
    first waypoint of the room's path, seeded weights and occlusion gate."""
    from trajectory_optimization_tpu_torch.utils.data import pad_points
    padded, valid = pad_points(room_scene(), 4096)
    rng = np.random.default_rng(3)
    w = rng.normal(size=len(padded)).astype(np.float32)
    occ = (rng.random(len(padded)) > 0.3).astype(np.float32)
    return padded, valid, room_path(), w, occ


HPR_CAP = 64  # below the room's bin counts: the stratified columns take part
HPR_STEPS = 2


def _problems(intr):
    import dataclasses
    from trajectory_optimization_tpu_torch.models.pose import PoseProblem
    from trajectory_optimization_tpu_torch.models.wps_opt import WpsOptProblem
    pose = PoseProblem(img_width=intr.width, img_height=intr.height, min_dist=1.0, max_dist=12.0,
                       soft_hpr=True, soft_hpr_dense_max=0, hpr_cap=HPR_CAP)
    wps = WpsOptProblem(img_width=intr.width, img_height=intr.height, min_dist=1.0,
                        max_dist=12.0, soft_hpr=True, soft_hpr_dense_max=0, hpr_cap=HPR_CAP)
    return {"soft": pose, "plain": dataclasses.replace(pose, soft_hpr=False)}, \
        {"soft": wps, "plain": dataclasses.replace(wps, soft_hpr=False)}


def _grads(loss_fn, params):
    from trajectory_optimization_tpu_torch.opt.engine import value_and_grad
    loss, aux, grads = value_and_grad(loss_fn, params)
    return loss, aux, grads


def hpr_checks(rank):
    from trajectory_optimization_tpu_torch.models.pose import init_pose_params, pose_forward
    from trajectory_optimization_tpu_torch.models.wps_opt import init_wps_params, wps_forward
    from trajectory_optimization_tpu_torch.ops import hpr as thpr
    from trajectory_optimization_tpu_torch.opt.engine import (
        OptimizerConfig, apply_updates, make_optimizer)
    from trajectory_optimization_tpu_torch.parallel.hpr_sharded import (
        hpr_mask_soft_binned_sharded)
    from trajectory_optimization_tpu_torch.parallel.mesh import all_reduce, points_sharding
    from trajectory_optimization_tpu_torch.parallel.pose_sharded import (
        make_sharded_pose_step, pose_loss_sharded)
    from trajectory_optimization_tpu_torch.parallel.wps_sharded import (
        make_sharded_wps_step, wps_loss_sharded)
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    intr = default_intrinsics()
    K = intr.matrix()
    out = {}
    ms = meshes()
    padded, valid, path, w, occ = hpr_inputs()
    cam = padded - path[0]
    pose_probs, wps_probs = _problems(intr)
    quat0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    cfg = OptimizerConfig(lr_pose=0.05, lr_quat=0.02)
    wps_path0 = path[:3]
    wps_quats0 = np.tile(quat0, (3, 1))

    def run(key, mesh):
        sl = (lambda x: points_sharding(mesh, x)) if mesh else torch.as_tensor
        reduce = (lambda x: all_reduce(x, mesh, "pts")) if mesh else (lambda x: x)
        V, W, O = sl(valid), sl(w), sl(occ)
        P = sl(cam).requires_grad_(True)
        if mesh:
            vis = hpr_mask_soft_binned_sharded(P, mesh, cap=HPR_CAP, valid=V)
        else:
            vis = thpr.hpr_mask_soft_binned(P, cap=HPR_CAP, valid=V)
        (dP,) = torch.autograd.grad(reduce(torch.sum(vis * W)), [P])
        out.update({f"{key}/hpr/vis": vis.detach(), f"{key}/hpr/dP": dP})
        Pw = sl(padded)
        for name, prob in pose_probs.items():
            for gate in ((None, O) if name == "soft" else (None,)):
                tag = f"{key}/pose/{name}" + ("" if gate is None else "_occ")
                if mesh:
                    fn = lambda p: _obs_aux(pose_loss_sharded(  # noqa: E731
                        mesh, p, Pw, V, K, prob, occlusion_mask=gate))
                else:
                    fn = lambda p: pose_forward(p, Pw, K, prob, valid=V,  # noqa: E731
                                                occlusion_mask=gate)
                loss, aux, g = _grads(fn, init_pose_params(path[0], quat0))
                out.update({f"{tag}/loss": loss, f"{tag}/obs": aux["observations"],
                            f"{tag}/dtrans": g["trans"], f"{tag}/dquat": g["quat"]})
        for name, prob in wps_probs.items():
            params, frozen = init_wps_params(wps_path0, wps_quats0)
            if mesh:
                fn = lambda p: wps_loss_sharded(mesh, p, frozen, Pw, V, K, prob)  # noqa: E731
            else:
                fn = lambda p: wps_forward(p, frozen, Pw, K, prob, valid=V)  # noqa: E731
            loss, aux, g = _grads(fn, params)
            out.update({f"{key}/wps/{name}/loss": loss, f"{key}/wps/{name}/losses": aux["losses"],
                        f"{key}/wps/{name}/obs": aux["observations"],
                        f"{key}/wps/{name}/dxy": g["xy"], f"{key}/wps/{name}/dyaw": g["yaw"]})
        # Adam steps of the occlusion-aware pose and waypoint problems
        pose = init_pose_params(path[0], quat0)
        wparams, frozen = init_wps_params(wps_path0, wps_quats0)
        if mesh:
            init_p, step_p = make_sharded_pose_step(mesh, pose_probs["soft"], cfg)
            init_w, step_w = make_sharded_wps_step(mesh, wps_probs["soft"], cfg)
            sp, sw = init_p(pose), init_w(wparams)
            for _ in range(HPR_STEPS):
                pose, sp, _, _ = step_p(pose, sp, Pw, V, K)
                wparams, sw, _, _ = step_w(wparams, sw, frozen, Pw, V, K)
        else:
            for prob, params, fn, keys in (
                    (pose_probs["soft"], pose,
                     lambda p, pr: pose_forward(p, Pw, K, pr, valid=V), ("trans", "quat")),
                    (wps_probs["soft"], wparams,
                     lambda p, pr: wps_forward(p, frozen, Pw, K, pr, valid=V), ("xy", "yaw"))):
                tx = make_optimizer(cfg, *keys)
                st = tx.init(params)
                for _ in range(HPR_STEPS):
                    _, _, g = _grads(lambda p: fn(p, prob), params)
                    upd, st = tx.update(g, st, params)
                    params.update(apply_updates(params, upd))
        out.update({f"{key}/step/trans": pose["trans"], f"{key}/step/quat": pose["quat"],
                    f"{key}/step/xy": wparams["xy"], f"{key}/step/yaw": wparams["yaw"]})

    if rank == 1:  # while rank 0 runs the 1-rank mesh
        run("single", None)
    for key, mesh in ms.items():
        if mesh.member:
            run(key, mesh)
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


def _obs_aux(loss_obs):
    loss, obs = loss_obs
    return loss, {"observations": obs}


# ---------------------------------------------------------------------------
# test_torch_parallel_traj.py: traj_sharded, traj_frozen_sharded
# ---------------------------------------------------------------------------

TRAJ_STEPS = 2
FROZEN_STEPS = 4


def traj_inputs(intr):
    """The room padded to 4,096 points and the first five waypoints of its
    path (five selected: the 2×2 mesh pads a dummy), soft HPR binned at
    cap 64."""
    from trajectory_optimization_tpu_torch.models.traj import TrajProblem
    from trajectory_optimization_tpu_torch.utils.data import pad_points
    padded, valid = pad_points(room_scene(), 4096)
    path = room_path()[:5]
    quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (5, 1))
    prob = TrajProblem(img_width=intr.width, img_height=intr.height, min_dist=1.0,
                       max_dist=12.0, wps_step=1, soft_hpr=True, soft_hpr_dense_max=0,
                       hpr_cap=HPR_CAP)
    return padded, valid, path, quats, prob


def traj_checks(rank):
    from trajectory_optimization_tpu_torch.models.traj import init_traj_params, traj_forward
    from trajectory_optimization_tpu_torch.models.traj_frozen import (
        FrozenPlanConfig, FrozenTrajOptimizer, build_traj_plan, put_plan, traj_forward_frozen)
    from trajectory_optimization_tpu_torch.opt.engine import (
        OptimizerConfig, apply_updates, make_optimizer)
    from trajectory_optimization_tpu_torch.parallel.mesh import points_sharding
    from trajectory_optimization_tpu_torch.parallel.traj_frozen_sharded import (
        FrozenShardedTrajOptimizer, build_frozen_sharded_plan, shard_plan,
        traj_frozen_loss_sharded)
    from trajectory_optimization_tpu_torch.parallel.traj_sharded import (
        make_sharded_traj_step, traj_soft_hpr_loss_sharded)
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    intr = default_intrinsics()
    K = intr.matrix()
    padded, valid, path, quats, prob = traj_inputs(intr)
    poses0, quats0 = torch.as_tensor(path), torch.as_tensor(quats)
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    out = {}
    ms = meshes()

    def record(tag, loss, aux, g):
        out.update({f"{tag}/loss": loss, f"{tag}/rewards": aux["rewards"],
                    f"{tag}/dposes": g["poses"], f"{tag}/dquats": g["quats"]})

    def run(key, mesh):
        sl = (lambda x: points_sharding(mesh, x)) if mesh else torch.as_tensor
        P, V = sl(padded), sl(valid)
        if mesh:
            fn = lambda p: traj_soft_hpr_loss_sharded(mesh, p, P, V, K, poses0, prob)  # noqa: E731
        else:
            fn = lambda p: traj_forward(p, P, K, poses0, quats0, prob, valid=V)  # noqa: E731
        record(f"{key}/soft", *_grads(fn, init_traj_params(path, quats)))
        # the frozen loss at a refresh: its plan built for the current waypoints
        if mesh:
            plan, meta = build_frozen_sharded_plan(padded, valid, path, quats, K.numpy(), prob,
                                                   d_wps=mesh.shape["wps"],
                                                   d_pts=mesh.shape["pts"])
            sub = put_plan(shard_plan(mesh, plan, meta), meta, "cpu")
            fn = lambda p: traj_frozen_loss_sharded(  # noqa: E731
                mesh, p, sub, meta, P, V, K, poses0, prob)
        else:
            plan, meta = build_traj_plan(padded, valid, path, quats, K.numpy(), prob)
            dev_plan = put_plan(plan, meta, "cpu")
            fn = lambda p: traj_forward_frozen(  # noqa: E731
                p, dev_plan, meta, P, K, poses0, quats0, prob, valid=V)
        record(f"{key}/frozen", *_grads(fn, init_traj_params(path, quats)))
        # Adam steps of the occlusion-aware trajectory
        params = init_traj_params(path, quats)
        if mesh:
            init_fn, step_fn = make_sharded_traj_step(mesh, prob, cfg)
            st = init_fn(params)
            for _ in range(TRAJ_STEPS):
                params, st, _, _ = step_fn(params, st, P, V, K, poses0, quats0)
        else:
            tx = make_optimizer(cfg)
            st = tx.init(params)
            for _ in range(TRAJ_STEPS):
                _, _, g = _grads(lambda p: traj_forward(p, P, K, poses0, quats0, prob, valid=V),
                                 params)
                upd, st = tx.update(g, st, params)
                params = apply_updates(params, upd)
        out.update({f"{key}/step/poses": params["poses"], f"{key}/step/quats": params["quats"]})
        # the frozen runners: one refresh every 2 steps, synchronous and not
        for mode in ("sync", "async"):
            pcfg = FrozenPlanConfig(refresh_every=2, async_refresh=mode == "async")
            if mesh:
                opt = FrozenShardedTrajOptimizer(mesh, padded, K, path, quats, prob, cfg, pcfg,
                                                 valid=valid)
            else:
                opt = FrozenTrajOptimizer(padded, K, path, quats, prob, cfg, pcfg, valid=valid,
                                          device="cpu")
            try:
                p_end, losses = opt.run(init_traj_params(path, quats), FROZEN_STEPS)
            finally:
                opt.close()
            out.update({f"{key}/runner_{mode}/losses": np.asarray(losses),
                        f"{key}/runner_{mode}/poses": p_end["poses"]})

    if rank == 1:  # while rank 0 runs the 1-rank mesh
        run("single", None)
    for key, mesh in ms.items():
        if mesh.member:
            run(key, mesh)
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# test_torch_parallel_multihost.py: multihost
# ---------------------------------------------------------------------------


def multihost_checks(rank, port, world):
    """Two processes, each holding only its own half of the cloud: the
    sharded train step through the fused passes, and the occlusion-aware
    pose loss and two steps; process 0 adds the single-device references
    from the whole cloud."""
    from trajectory_optimization_tpu_torch.models.pose import init_pose_params, pose_forward
    from trajectory_optimization_tpu_torch.models.traj import TrajProblem, init_traj_params, traj_forward
    from trajectory_optimization_tpu_torch.opt.engine import (
        OptimizerConfig, apply_updates, make_optimizer)
    from trajectory_optimization_tpu_torch.parallel.multihost import (
        initialize_distributed, make_multihost_mesh, shard_points_multihost)
    from trajectory_optimization_tpu_torch.parallel.pose_sharded import (
        make_sharded_pose_step, pose_loss_sharded)
    from trajectory_optimization_tpu_torch.parallel.sharded import make_sharded_train_step
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")  # a no-op now
    out = {}
    try:
        make_multihost_mesh(wps=3, devices=["cpu"] * world)
    except ValueError as e:
        out["reject"] = np.asarray("not divisible by wps=3" in str(e))
    mesh = make_multihost_mesh(devices=["cpu"] * world)
    intr = default_intrinsics()
    K = intr.matrix()
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)

    padded, valid, path, quats = train_inputs()
    n_l = len(padded) // world
    own = slice(rank * n_l, (rank + 1) * n_l)  # this process's data only
    P, V = shard_points_multihost(mesh, padded[own], valid[own])
    prob = TrajProblem(img_width=intr.width, img_height=intr.height, wps_step=2,
                       backend="pallas")
    poses0, quats0 = torch.as_tensor(path), torch.as_tensor(quats)
    init_fn, step_fn = make_sharded_train_step(mesh, prob, cfg)
    losses, params = _train(step_fn, init_fn, init_traj_params(path, quats), P, V, K, poses0,
                            quats0)
    out.update({"traj/losses": losses, "traj/poses": params["poses"],
                "traj/quats": params["quats"]})

    hp, hv, hpath, _, _ = hpr_inputs()
    pose_probs, _ = _problems(intr)
    quat0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    n_l = len(hp) // world
    own = slice(rank * n_l, (rank + 1) * n_l)
    HP, HV = shard_points_multihost(mesh, hp[own], hv[own])
    out["pose/loss0"] = pose_loss_sharded(mesh, init_pose_params(hpath[0], quat0), HP, HV, K,
                                          pose_probs["soft"])[0].detach()
    init_p, step_p = make_sharded_pose_step(mesh, pose_probs["soft"], cfg)
    pose = init_pose_params(hpath[0], quat0)
    st = init_p(pose)
    for _ in range(HPR_STEPS):
        pose, st, _, _ = step_p(pose, st, HP, HV, K)
    out.update({"pose/trans": pose["trans"], "pose/quat": pose["quat"]})

    if rank == 0:
        Pt, Vt = torch.as_tensor(padded), torch.as_tensor(valid)
        kprob = TrajProblem(img_width=intr.width, img_height=intr.height, wps_step=2,
                            backend="kernel")
        tx = make_optimizer(cfg)
        params = init_traj_params(path, quats)
        st = tx.init(params)
        losses = []
        for _ in range(TRAIN_STEPS):
            loss, _, g = _grads(lambda p: traj_forward(p, Pt, K, poses0, quats0, kprob, valid=Vt),
                                params)
            upd, st = tx.update(g, st, params)
            params = apply_updates(params, upd)
            losses.append(float(loss))
        out.update({"ref/traj/losses": np.asarray(losses), "ref/traj/poses": params["poses"],
                    "ref/traj/quats": params["quats"]})
        HPt, HVt = torch.as_tensor(hp), torch.as_tensor(hv)
        fn = lambda p: pose_forward(p, HPt, K, pose_probs["soft"], valid=HVt)  # noqa: E731
        out["ref/pose/loss0"] = fn(init_pose_params(hpath[0], quat0))[0].detach()
        tx = make_optimizer(cfg, "trans", "quat")
        pose = init_pose_params(hpath[0], quat0)
        st = tx.init(pose)
        for _ in range(HPR_STEPS):
            _, _, g = _grads(fn, pose)
            upd, st = tx.update(g, st, pose)
            pose = apply_updates(pose, upd)
        out.update({"ref/pose/trans": pose["trans"], "ref/pose/quat": pose["quat"]})
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
