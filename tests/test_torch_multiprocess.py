"""The port's render over two real processes on the CPU: two OS processes
join a ``torch.distributed`` gloo group on a localhost port
(``parallel.render_sharded.initialize_multihost``) and render Cornell 32x16
spp 2 over a process-group mesh, one shard each, the frame assembled by
``all_gather``; they also sum the shards' gradients with ``all_reduce``. The frame must be BITWISE
equal to one process's render (the seeds are drawn over the whole frame and
every shard traces absolute pixel ids), the gradients equal within rtol
1e-5 (tests/test_sharding.py:127). The twin of tests/test_multihost.py,
which is marked slow; this one takes a few seconds."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 25

# One rank: the K1 route and the plain route of the frame, the sharded
# gradient; rank 0 saves them.
_RANK = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.parallel.mesh import make_mesh
from se195_raytracer_tpu_torch.parallel import render_sharded as rs
from se195_raytracer_tpu_torch.scenes.registry import get_scene

port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
rs.initialize_multihost(f"127.0.0.1:{port}", 2, rank)
mesh = make_mesh("cpu", process_group=True)
assert mesh.size == 2 and mesh.local_shards == (rank,)
spec = get_scene("cornell")
scene, cam = spec.to_scene("cpu"), spec.to_camera("cpu")
res = {}
cfg = RenderConfig(width=32, height=16, spp=2, seed=6)
res["k1"], st = rs.render_cuda_sharded(scene, cam, cfg, mesh)
res["k1_lanes"] = np.array(st[0].shape[0])
res["k1_resumed"], _ = rs.render_cuda_sharded(scene, cam, cfg, mesh, state=st)
cfg_plain = RenderConfig(width=32, height=16, spp=2, seed=6, use_kernel=False)
res["plain"], _ = rs.render_sharded(scene, cam, cfg_plain, mesh)
simple = get_scene("simple")
gcfg = RenderConfig(width=16, height=16, spp=1, seed=2, max_depth=3)
loss, grads = rs.l2_image_loss_sharded(simple.to_scene("cpu"), simple.to_camera("cpu"),
                                       torch.zeros((16, 16, 3)), gcfg, mesh)
res["loss"] = loss
res.update({"grad_" + k: g for k, g in grads.items()})
if rank == 0:
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs the port's CPU code on one intra-op thread: the suite
    runs several pytest workers at once, and torch's OpenMP threads, one
    team per worker, then stall each other on the plain tracers' many small
    ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_ranks(out: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(port), str(rank), out],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{err[-3000:]}"


def test_two_gloo_processes_match_one_process(tmp_path):
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver.optimize import CAMERA_LEAVES, LEAVES, l2_image_loss, merge
    from se195_raytracer_tpu_torch.driver.render import render
    from se195_raytracer_tpu_torch.kernels.pt_kernel import render_cuda
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    out = str(tmp_path / "ranks.npz")
    _run_two_ranks(out)
    got = np.load(out)

    spec = get_scene("cornell")
    scene, cam = spec.to_scene("cpu"), spec.to_camera("cpu")
    cfg = RenderConfig(width=32, height=16, spp=2, seed=6)
    img, st = render_cuda(scene, cam, cfg, device="cpu")
    np.testing.assert_array_equal(got["k1"], img.numpy())
    assert int(got["k1_lanes"]) == 2048  # rank 0's shard: one of the two tiles
    img2, _ = render_cuda(scene, cam, cfg, device="cpu", state=st)
    np.testing.assert_array_equal(got["k1_resumed"], img2.numpy())
    plain, _ = render(scene, cam, RenderConfig(width=32, height=16, spp=2, seed=6,
                                               use_kernel=False), device="cpu")
    np.testing.assert_array_equal(got["plain"], plain.numpy())

    simple = get_scene("simple")
    s, c = simple.to_scene("cpu"), simple.to_camera("cpu")
    leaves = {k: getattr(c if k in CAMERA_LEAVES else s, k).detach().clone()
              .requires_grad_(True) for k in LEAVES}
    s1, c1 = merge(s, c, leaves)
    gcfg = RenderConfig(width=16, height=16, spp=1, seed=2, max_depth=3)
    loss = l2_image_loss(s1, c1, torch.zeros((16, 16, 3)), gcfg, device="cpu")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(got["loss"]), loss.item(), rtol=1e-5)
    for k, g in zip(LEAVES, grads):
        np.testing.assert_allclose(got["grad_" + k], g.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
