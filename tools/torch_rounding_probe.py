"""How torch's CUDA kernels round the plain path's compound operations.

K1b (kernels/csrc/pt_backward_kernel.cu) replays the plain smallpt path bit
for bit, so it must round as torch's card kernels do. Most of the plain
path is one rounding per operation; this probe checks the two that are
not obviously so, on random inputs on the card:

* ``torch.linalg.cross``: a1 * b2 - a2 * b1 with two roundings, or as one
  FMA over either rounded product;
* a float32 tensor divided by a Python scalar (the running mean's
  ``/ (k + 1)``): a true division, or a product with the float reciprocal;

and, for reference, ``1.0 / x`` and ``sqrt`` against the correctly rounded
results. Prints the card's name and power limit and the number of
components that differ from each candidate.

Usage: python tools/torch_rounding_probe.py [--n 1048576]
"""

from __future__ import annotations

import argparse
import subprocess


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    g = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn((args.n, 3), generator=g).cuda()
    b = torch.randn((args.n, 3), generator=g).cuda()
    a = a / a.norm(dim=1, keepdim=True)
    b = b / b.norm(dim=1, keepdim=True)
    c = torch.linalg.cross(a, b, dim=-1)
    # (first product, second product) of each component of a x b
    pairs = [((a[:, 1], b[:, 2]), (a[:, 2], b[:, 1])), ((a[:, 2], b[:, 0]), (a[:, 0], b[:, 2])),
             ((a[:, 0], b[:, 1]), (a[:, 1], b[:, 0]))]
    f32 = torch.float32
    # An FMA is emulated in float64: the product of two floats is exact there.
    candidates = {
        "two roundings": lambda p, q: p[0] * p[1] - q[0] * q[1],
        "fma(a1, b2, -(a2 * b1))": lambda p, q: (p[0].double() * p[1].double()
                                                 - (q[0] * q[1]).double()).to(f32),
        "fma(-a2, b1, a1 * b2)": lambda p, q: ((p[0] * p[1]).double()
                                               - q[0].double() * q[1].double()).to(f32),
    }
    for name, fn in candidates.items():
        v = torch.stack([fn(p, q) for p, q in pairs], dim=-1)
        print(f"cross as {name}: {int((v != c).sum())} of {v.numel()} components differ")
    x = torch.rand(args.n, generator=g).cuda() * 10
    for k in (3.0, 5.0, 6.0, 7.0):
        d = x / k
        recip = float(torch.tensor(1.0 / k, dtype=f32))
        print(f"x / {k}: differs from x * float32(1 / {k}) in {int((d != x * recip).sum())}, "
              f"from the true quotient in {int((d != (x.double() / k).to(f32)).sum())}")
    print(f"1.0 / x differs from the rounded reciprocal in "
          f"{int(((1.0 / x) != (1.0 / x.double()).to(f32)).sum())}")
    print(f"sqrt(x) differs from the rounded float64 root in "
          f"{int((torch.sqrt(x) != torch.sqrt(x.double()).to(f32)).sum())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
