"""One rank of the port's mesh tests (tests/test_torch_sharding.py,
tests/test_torch_vo_mesh.py), run as a subprocess on the CPU over gloo.

    python tests/torch_mesh_worker.py RANK WORLD STORE TILING CASES INPUTS OUT

joins the group through a ``FileStore`` file (``STORE``; no TCP port, so
parallel test runs never collide), builds the ``TILING`` mesh
("b,ty,tx", or "none" for no mesh), runs each case named in the
comma-separated ``CASES`` on the arrays of ``INPUTS`` (.npz) and writes
``OUT/rank<RANK>.npz`` with every case's results under "case/key". A case
that expects a refusal records it as a flag. Imports ``tpuflow_torch``
only, never JAX. Every process group waits at most ``mesh.TIMEOUT`` for
a peer, and the harness (tests/mesh_harness.py) kills a run past its wall
limit, so a rank that fails or hangs fails the test instead of stalling
the suite.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuflow_torch.core.config import PyramidConfig  # noqa: E402
from tpuflow_torch.sharding import (  # noqa: E402
    dist_pyramid, exchange_halo_2d, initialize_multihost, make_flow_mesh,
    tiled_lucas_kanade_pyramidal, tiled_lucas_kanade_single_scale,
)
from tpuflow_torch.sharding.mesh import counters  # noqa: E402

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _raises(fn, exc=ValueError) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _pyr(mesh, inp, prefix, cfg, backend="torch"):
    u, v = tiled_lucas_kanade_pyramidal(_t(inp[f"{prefix}_prev"]), _t(inp[f"{prefix}_curr"]),
                                        mesh, config=cfg, backend=backend)
    return {"u": u.numpy(), "v": v.numpy()}


# -- tpuflow.sharding's cases (tests/test_torch_sharding.py) ---------------------------------


@case
def mesh(mesh, inp):
    b, iy, ix = mesh.coords
    bigger = _raises(lambda: make_flow_mesh(batch=2, ty=2, tx=2, device="cpu"))
    return {"shape": np.array([mesh.batch, mesh.ty, mesh.tx]), "coords": np.array([b, iy, ix]),
            "refused": np.array(bigger)}


@case
def halo(mesh, inp):
    _, iy, ix = mesh.coords
    img = inp["halo_img"][0]
    th, tw = img.shape[0] // mesh.ty, img.shape[1] // mesh.tx
    tile = _t(img[iy * th:(iy + 1) * th, ix * tw:(ix + 1) * tw])
    return {"symm": exchange_halo_2d(tile, 3, mesh, boundary="symm").numpy(),
            "zero": exchange_halo_2d(tile, 3, mesh, boundary="zero").numpy()}


@case
def single(mesh, inp):
    u, v = tiled_lucas_kanade_single_scale(_t(inp["ss_prev"]), _t(inp["ss_curr"]), mesh)
    return {"u": u.numpy(), "v": v.numpy()}


@case
def bad_tiling(mesh, inp):
    frames = torch.zeros((1, 48, 63))
    return {"refused": np.array(_raises(
        lambda: tiled_lucas_kanade_single_scale(frames, frames, mesh)))}


@case
def pyr_torch(mesh, inp):
    counters.reset()
    out = _pyr(mesh, inp, "pyr", PyramidConfig(levels=3, window_size=5, iterations=2))
    return {**out, "level_gathers": np.array(counters.level_gathers)}


@case
def pyr_cuda(mesh, inp):
    return _pyr(mesh, inp, "pc", PyramidConfig(levels=2, iterations=2), backend="cuda")


@case
def narrow(mesh, inp):
    return _pyr(mesh, inp, "nv", PyramidConfig(levels=3, window_size=5, iterations=2,
                                                max_disp_v=3))


@case
def fully(mesh, inp):
    counters.reset()
    out = _pyr(mesh, inp, "fd", PyramidConfig(levels=3, window_size=5, iterations=2, max_disp=4))
    return {**out, "level_gathers": np.array(counters.level_gathers),
            "halo_bytes": np.array(counters.halo_bytes)}


@case
def down_up(mesh, inp):
    _, iy, ix = mesh.coords
    img = inp["down_img"][0]
    gh, gw = img.shape
    tile = _t(img[iy * gh // mesh.ty:(iy + 1) * gh // mesh.ty,
                  ix * gw // mesh.tx:(ix + 1) * gw // mesh.tx])
    down = dist_pyramid.sharded_downsample(tile, (gh, gw), (gh // 2, gw // 2), 2.0, mesh=mesh)
    u, v = inp["up_u"][0], inp["up_v"][0]
    ch, cw = u.shape
    sl = np.s_[iy * ch // mesh.ty:(iy + 1) * ch // mesh.ty,
               ix * cw // mesh.tx:(ix + 1) * cw // mesh.tx]
    su, sv = dist_pyramid.sharded_upsample_flow(_t(u[sl]), _t(v[sl]), (ch, cw), (2 * ch, 2 * cw),
                                                mesh=mesh)
    ru, rv = dist_pyramid.replicated_to_sharded_upsample(_t(u), _t(v), (2 * ch, 2 * cw),
                                                         mesh=mesh)
    return {"down": down.numpy(), "up_u": su.numpy(), "up_v": sv.numpy(),
            "rep_u": ru.numpy(), "rep_v": rv.numpy()}


# -- the tiled path under device control (tests/test_torch_tiled_device.py) -------------------

# The device-controlled cases' configs, by input prefix: "pc" as
# tests/test_torch_sharding.py's pyr_cuda; "wd" the early-exit witness
# (a patch moving past a 2 px band on a flat field).
DEVICE_CFGS = {"pc": dict(levels=2, iterations=2),
               "wd": dict(levels=3, window_size=5, iterations=3, max_disp=2)}


@case
def tiled_device(mesh, inp):
    """``backend="cuda"`` under device control and its host-steered twin
    (the same kernels' plain versions, the early exit read to the host):
    flows, rounds per level, host reads."""
    from tpuflow_torch.sharding import tiled_pyramidal as tp

    out = {}
    for prefix, kw in DEVICE_CFGS.items():
        cfg = PyramidConfig(**kw)
        prev, curr = _t(inp[f"{prefix}_prev"]), _t(inp[f"{prefix}_curr"])
        counters.reset()
        u, v = tiled_lucas_kanade_pyramidal(prev, curr, mesh, config=cfg, backend="cuda")
        out.update({f"{prefix}_u": u.numpy(), f"{prefix}_v": v.numpy(),
                    f"{prefix}_rounds": counters.level_rounds.numpy(),
                    f"{prefix}_reads": np.array(counters.convergence_reads)})
        counters.reset()
        u, v = tp._tiled_solve(prev, curr, mesh, cfg, "cuda", device_control=False)
        out.update({f"{prefix}_host_u": u.numpy(), f"{prefix}_host_v": v.numpy(),
                    f"{prefix}_host_reads": np.array(counters.convergence_reads)})
    return out


class _HostRead(RuntimeError):
    pass


def _host_reads_raise():
    """Make every way of reading a tensor's value to the host raise;
    returns the undo."""
    names = ("__bool__", "item", "tolist", "__float__", "__int__", "__index__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(self, *args, **kwargs):
        raise _HostRead("a tensor's value was read to the host")

    for n in names:
        setattr(torch.Tensor, n, refuse)

    def undo():
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)

    return undo


@case
def no_host_read(mesh, inp):
    """The device-controlled step with every host read refused, and the
    host-steered loop under the same refusal (it must be caught)."""
    from tpuflow_torch.sharding import tiled_pyramidal as tp

    out = {}
    for prefix, kw in DEVICE_CFGS.items():
        cfg = PyramidConfig(**kw)
        prev, curr = _t(inp[f"{prefix}_prev"]), _t(inp[f"{prefix}_curr"])
        for name, fn in (("device", tiled_lucas_kanade_pyramidal),
                         ("host", lambda *a, **k: tp._tiled_solve(*a[:3], k["config"], "cuda",
                                                                  device_control=False))):
            undo = _host_reads_raise()
            try:
                u, v = fn(prev, curr, mesh, config=cfg, backend="cuda")
                raised = False
            except _HostRead:
                raised = True
            finally:
                undo()
            out[f"{prefix}_{name}_raised"] = np.array(raised)
            if name == "device":
                out[f"{prefix}_u"], out[f"{prefix}_v"] = u.numpy(), v.numpy()
        # Every rank raises at the same read, so the ranks stay in step.
        dist.barrier(mesh.group)
    return out


@case
def graph_refusals(mesh, inp):
    """A gloo mesh is never graphed: the VO front end steps eagerly and the
    tiled graph stream refuses it."""
    from tpuflow_torch.flow import graphed
    from tpuflow_torch.vo.device_loop import FrontEnd

    fe = FrontEnd(backend="cuda", mesh=mesh)
    return {"graphable": np.array(graphed.graphable_mesh(mesh)),
            "vo_graphed": np.array(fe.graphed(torch.zeros((1, 8, 8))))}


# -- tpuflow.vo's mesh cases (tests/test_torch_vo_mesh.py) -----------------------------------


def _session(mesh, inp, **kw):
    from tpuflow_torch.vo.pipeline import OdometrySession

    return OdometrySession(tuple(inp["intr"]), grid_step=16, mesh=mesh, device="cpu", **kw)


def _obs(sess) -> dict:
    return {"uv": np.stack(sess.obs_uv), "valid": np.stack(sess.obs_valid),
            "lm": np.stack(sess.obs_lm)}


@case
def vo_session(mesh, inp):
    sess = _session(mesh, inp)
    for f in inp["vo_frames"]:
        sess.process_frame(f)
    return _obs(sess)


@case
def vo_resume(mesh, inp):
    from tpuflow_torch.vo import checkpoint

    frames = inp["vo_frames"]
    sess = _session(mesh, inp)
    for f in frames[:3]:
        sess.process_frame(f)
    # Each rank writes its own checkpoint: a tiled session's state is the
    # same on every rank.
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "tiled")
        checkpoint.save(sess, ckpt)
        untiled_refused = _raises(lambda: checkpoint.load(ckpt, device="cpu"))
        resumed = checkpoint.load(ckpt, mesh=mesh, device="cpu")
        plain = _session(None, inp)
        plain.process_frame(frames[0])
        plain.process_frame(frames[1])
        ckpt2 = str(Path(tmp) / "plain")
        checkpoint.save(plain, ckpt2)
        mesh_refused = _raises(lambda: checkpoint.load(ckpt2, mesh=mesh, device="cpu"))
    for f in frames[3:]:
        sess.process_frame(f)
        resumed.process_frame(f)
    a, b = _obs(sess), _obs(resumed)
    return {"untiled_refused": np.array(untiled_refused), "mesh_refused": np.array(mesh_refused),
            "same_mesh": np.array(resumed.mesh is mesh),
            "tiled_meta": np.array(resumed.meta_dict()["tiled"]),
            "identical": np.array(all(np.array_equal(a[k], b[k]) for k in a))}


@case
def vo_convert(mesh, inp):
    from tpuflow_torch import convert

    meta = json.loads(str(inp["conv_meta"]))
    state = {k[len("conv_state/"):]: inp[k] for k in inp.files if k.startswith("conv_state/")}
    refused = _raises(lambda: convert.session_from_reference(meta, state, device="cpu"))
    sess = convert.session_from_reference(meta, state, device="cpu", mesh=mesh)
    for f in inp["conv_frames"]:
        sess.process_frame(f)
    return {"refused": np.array(refused), **_obs(sess)}


@case
def ba_sharded(mesh, inp):
    from tpuflow_torch.vo import ba

    rank = dist.get_rank(mesh.group)
    n = dist.get_world_size(mesh.group)
    fields = {f: torch.from_numpy(inp[f"ba/{f}"]) for f in ba.BAProblem._fields}
    full = ba.BAProblem(**fields)
    shard = slice(rank * full.obs_uv.shape[0] // n, (rank + 1) * full.obs_uv.shape[0] // n)
    local = full._replace(obs_uv=full.obs_uv[shard], obs_cam=full.obs_cam[shard],
                          obs_lm=full.obs_lm[shard], obs_valid=full.obs_valid[shard])
    k, m = full.poses_r.shape[0], full.landmarks.shape[0]
    p = local
    for _ in range(6):
        p = ba.gauss_newton_step(p, axis_name=mesh.group, num_cams=k, num_lms=m)
    lm_solve = ba.solve(local, iterations=8, axis_name=mesh.group)
    again = ba.solve(local, iterations=8, axis_name=mesh.group)
    return {"poses_r": p.poses_r.numpy(), "poses_t": p.poses_t.numpy(),
            "landmarks": p.landmarks.numpy(), "lm_poses_r": lm_solve.poses_r.numpy(),
            "lm_poses_t": lm_solve.poses_t.numpy(),
            "lm_landmarks": lm_solve.landmarks.numpy(),
            "lm_repeat": np.array(all(torch.equal(a, b) for a, b in zip(lm_solve, again)))}


@case
def multihost(mesh, inp):
    again = initialize_multihost("file:///nonexistent", dist.get_world_size(),
                                 dist.get_rank(), backend="gloo")
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    return {"reentry": np.array(again), "sum": x.numpy(), "world": np.array(dist.get_world_size())}


def main(argv: list[str]) -> None:
    rank, world, store, tiling, cases, inputs, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    joined = initialize_multihost(f"file://{store}", world, rank, backend="gloo")
    mesh = None
    if tiling != "none":
        mesh = make_flow_mesh(*(int(x) for x in tiling.split(",")), device="cpu")
    inp = np.load(inputs, allow_pickle=False)
    results = {"joined": np.array(joined)}
    for name in cases.split(","):
        for key, value in CASES[name](mesh, inp).items():
            results[f"{name}/{key}"] = np.asarray(value)
    dist.barrier()
    np.savez(Path(out) / f"rank{rank}.npz", **results)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
