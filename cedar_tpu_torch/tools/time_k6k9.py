"""Device ms of K6-K9's non-periodic launches, float32, in the checkout
given as the first argument (this one, or another unpacked with ``git
archive``, e.g. the parent's): K6 resident at 16³ 27-point with the
residual, K6 a launch a colour at 64³ 27-point and 128³ 7-point with the
residual, K7, K8 and K9 at 256³ 7-point.  For checking that a change left
these launches' times as they were: run the two checkouts in turns in one
call (parent, change, change, parent).

    python3 cedar_tpu_torch/tools/time_k6k9.py DIR

Run it as a script path, not ``-m``, so that DIR's package is the one
imported.
"""

import os
import sys


def main(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import cedar_tpu_torch
    from cedar_tpu_torch.core.types import StencilKind
    from cedar_tpu_torch.ops import cuda3, cuda_transfer3, interp3, stencil3
    from cedar_tpu_torch.tools.tune_fused3 import device_ms

    if not cedar_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {cedar_tpu_torch.__file__}, not {tree}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)

    def prob(n, ts):
        kind = StencilKind.twenty_seven_pt if ts else StencilKind.seven_pt
        so = torch.rand((kind.ndirs, n, n, n), generator=g, device=dev) * 0.2
        so[0] = stencil3.offdiag_apply(so, torch.ones((n,) * 3, device=dev),
                                       kind) + 0.1
        q = torch.randn((n,) * 3, generator=g, device=dev)
        b = torch.randn((n,) * 3, generator=g, device=dev)
        return so, q, b, kind

    out = {}
    so, q, b, k = prob(16, True)
    out["K6 resident 16^3 27pt +res"] = device_ms(
        lambda: cuda3.sweep(so, q, b, k, "down", True), reps=50)
    so, q, b, k = prob(64, True)
    out["K6 phases 64^3 27pt +res"] = device_ms(
        lambda: cuda3.sweep(so, q, b, k, "down", True), reps=20)
    so, q, b, k = prob(128, False)
    ph = cuda3.Plan("phases")
    out["K6 phases 128^3 7pt +res"] = device_ms(
        lambda: cuda3._sweep(ph, so, q, b, k, "down", True), reps=20)
    so, q, b, k = prob(256, False)
    ci = interp3.setup_interp(so, k)
    qc = torch.randn((128,) * 3, generator=g, device=dev)
    out["K7 256^3"] = device_ms(lambda: cuda_transfer3.restrict(ci, b),
                                reps=20)
    out["K8 256^3"] = device_ms(
        lambda: cuda_transfer3.interp_add(ci, so, qc, b, q), reps=20)
    out["K9 256^3"] = device_ms(
        lambda: cuda_transfer3.interp(ci, qc, (256,) * 3), reps=20)
    for key, ms in out.items():
        print(f"{tree}: {key}: device {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
