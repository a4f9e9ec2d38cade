"""Plant faults in K1b's reverse sweep and show whether its bar catches them
(needs a GPU and nvcc).

Each fault (``FAULTS``) is a one-line edit of
``se195_raytracer_tpu_torch/kernels/csrc/pt_backward_kernel.cu`` that drops
or breaks one term of the adjoint. For the unedited source and for each
fault the port is copied into a temporary directory (the checkout is never
edited), the line is edited in the copy, the copies' K1b are built together,
and one child process per copy holds its K1b to ``pt_backward_reference`` on
Cornell at 512² spp 2 (the grad phase's frame): PT on the image mean's
cotangent, on a random one and on the L2 loss's at the gradient benchmark's
start, DL on a random one. For each it prints each field's worst-row error
(``pt_backward_kernel.grad_row_error``, the bar ``GRAD_ROW_REL``) and, for
comparison, max |diff| over the field's largest gradient. It exits 1 unless
the unedited kernel passes the bar and every fault fails it.

    python3 tools/k1b_fault_check.py --out chiprun_out/k1b_faults.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "se195_raytracer_tpu_torch"
CU = os.path.join(PKG, "kernels", "csrc", "pt_backward_kernel.cu")
# name -> (the line's text in the source, its replacement)
FAULTS = {
    "diffuse bounce: no cosine_dir term through nl": (
        "g_nl = g_nl + g_w;", "(void)g_w;"),
    "light sample: no wi term through nl": (
        "g_nl = g_nl + g_wi * L.sd;", "(void)g_wi;"),
    "refraction: no Fresnel term": (
        "g_re += 0.5f * g_p;", "g_re = 0.0f;"),
    "refraction: no kk n term of the transmitted direction": (
        "g_n = g_n - r.kk * g_td0;", "(void)r.kk;"),
    "mirror: no normal term of the reflected direction": (
        "g_n = g_n - (2.0f * h.dp) * g_dn;", "(void)h.dp;"),
    "hit distance: the entry root's sign on every hit": (
        "const float sgn_sq = Rn::sub(qd.b, qd.sq) > kEps ? -1.0f : 1.0f;",
        "const float sgn_sq = -1.0f;"),
}
UNEDITED = "unedited"
SIZE = 512


def _child() -> int:
    """In a copy of the port: K1b against its plain version, one JSON line."""
    import numpy as np
    import torch

    import se195_raytracer_tpu_torch as pkg
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.core.types import CameraBasis, update_camera
    from se195_raytracer_tpu_torch.driver import grad_check as G
    from se195_raytracer_tpu_torch.driver.optimize import _render_plain_diff
    from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as K
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    assert os.path.abspath(pkg.__file__).startswith(os.getcwd()), pkg.__file__
    spec = get_scene("cornell")
    scene, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
    start = G.grad_bench_start(scene)
    out = {}
    for integ in ("pt", "dl"):
        cfg = RenderConfig(width=SIZE, height=SIZE, spp=2, seed=5, integrator=integ)
        b = update_camera(cam, SIZE, SIZE)
        basis = CameraBasis(*(getattr(b, k).detach() for k in K.BASIS_FIELDS))
        rnd = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (SIZE, SIZE, 3)).astype(np.float32)).cuda()
        cots = {"random": (scene, rnd)}
        if integ == "pt":
            with torch.no_grad():
                target = _render_plain_diff(scene, cam, cfg)
                img = _render_plain_diff(start, cam, cfg)
            cots["mean"] = (scene, torch.full_like(rnd, 1.0 / rnd.numel()))
            cots["loss"] = (start, 2.0 * (img - target) / img.numel())
        for name, (sc, g) in cots.items():
            n = sc.num_spheres
            a = K.unpack_grad(K.pt_backward_cuda(sc, basis, cfg, g), n)
            r = K.unpack_grad(K.pt_backward_reference(sc, basis, cfg, g), n)
            field = {k: float((a[k] - r[k]).abs().max()) / (float(r[k].abs().max()) or 1.0)
                     for k in r}
            out[f"{integ} {name}"] = {"row": K.grad_row_error(a, r), "field": field,
                                      "finite": bool(all(torch.isfinite(v).all()
                                                         for v in a.values()))}
    print(json.dumps({"results": out, "bar": K.GRAD_ROW_REL}))
    return 0


def _copy(dst: str, fault) -> None:
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault is None:
        return
    path = os.path.join(dst, CU)
    with open(path) as f:
        text = f.read()
    old, new = fault
    if text.count(old) != 1:
        raise RuntimeError(f"the fault's line {old!r} is not in {CU} exactly once")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        return _child()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="k1b_faults.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from se195_raytracer_tpu_torch.kernels._build import build_all, sources

    build_all(sources())  # the checkout's kernels, then copied with each variant
    variants = {UNEDITED: None, **FAULTS}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for i, (name, fault) in enumerate(variants.items()):
            dirs[name] = os.path.join(tmp, str(i))
            _copy(dirs[name], fault)
        env = dict(os.environ)
        build = ("from se195_raytracer_tpu_torch.kernels._build import build_all; "
                 "build_all(['pt_backward_kernel'])")
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d,
                                  env=dict(env, PYTHONPATH=d)) for d in dirs.values()]
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError("a variant's K1b did not build")
        for name, d in dirs.items():
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"],
                                  cwd=d, env=dict(env, PYTHONPATH=d),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: {proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            bar = res["bar"]
            worst = max(max(v["row"].values()) for v in res["results"].values())
            results[name] = {**res, "worst_row": worst, "passes": worst <= bar and all(
                v["finite"] for v in res["results"].values())}
            print(f"{name}: worst row error {worst:.4g} (bar {bar}), passes "
                  f"{results[name]['passes']}", flush=True)
            for cot, v in res["results"].items():
                print(f"    {cot}: row " + ", ".join(f"{k} {e:.3g}" for k, e in v["row"].items())
                      + " | field " + ", ".join(f"{k} {e:.3g}" for k, e in v["field"].items()),
                      flush=True)
    caught = all(not results[n]["passes"] for n in FAULTS)
    print(f"unedited passes: {results[UNEDITED]['passes']}; every fault caught: {caught}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"size": SIZE, "variants": results}, f, indent=1)
    return 0 if results[UNEDITED]["passes"] and caught else 1


if __name__ == "__main__":
    sys.exit(main())
