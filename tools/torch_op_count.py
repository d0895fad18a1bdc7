"""Count the PyTorch operator calls of the port's per-frame host paths.

    PYTHONPATH=. python tools/torch_op_count.py

On the CPU, at default_config(), for one call each of core/pnp.pnp_step
with the motion-only solve, solve_pnp_window alone, the new edge's
preintegration (preintegration.propagate) and the IMU factors' residuals
and Jacobians (pnp._imu_local), prints the number of aten calls that
torch.profiler records at the top level (what the Python code issues)
and in all. Where the host sets the pace, as on the H100 (PERF.md
section 5), a path's wall time follows its top-level count. The inputs
are random (seeded): the count does not depend on their values.
"""
import torch
from torch.profiler import ProfilerActivity, profile

from vins_tpu_torch import default_config
from vins_tpu_torch.core import pnp as pnp_mod
from vins_tpu_torch.core import preintegration as pre_mod
from vins_tpu_torch.pipeline import default_extrinsics


def main() -> None:
    cfg = default_config()
    S = cfg.window.pnp_size + 1
    Mp = cfg.window.max_landmarks
    N = cfg.window.max_imu_per_edge
    g = torch.Generator().manual_seed(0)
    st = pnp_mod.PnpState.identity(S)
    st = st._replace(p=torch.randn(S, 3, generator=g) * 0.1)
    chunks = pre_mod.ImuChunk(
        dt=torch.full((S - 1, N), 1e-3),
        acc=torch.randn(S - 1, N, 3, generator=g) + torch.tensor(
            [0.0, 0.0, 9.8]),
        gyr=torch.randn(S - 1, N, 3, generator=g) * 0.1)
    feats = pnp_mod.PnpFeatures(
        pts_w=torch.randn(Mp, 3, generator=g) + torch.tensor([0.0, 0.0, 5.0]),
        obs=torch.randn(S, Mp, 2, generator=g) * 0.1,
        mask=torch.rand(S, Mp, generator=g) > 0.5, weight=torch.ones(Mp))
    win = pnp_mod.PnpWindow(state=st, feats=feats, chunks=chunks,
                            anchored=torch.zeros(S, dtype=torch.bool))
    win = win._replace(preints=pnp_mod.window_preints(win, cfg))
    ext = default_extrinsics(cfg, "cpu")
    grav = torch.tensor([0.0, 0.0, cfg.imu.gravity])
    chunk = pre_mod.ImuChunk(*[x[0] for x in chunks])
    paths = [
        ("pnp_step (solve)", lambda: pnp_mod.pnp_step(
            win, chunk, feats.obs[0], feats.mask[0], cfg, ext, grav)),
        ("solve_pnp_window", lambda: pnp_mod.solve_pnp_window(
            win, cfg, ext, grav)),
        ("propagate, one edge", lambda: pre_mod.propagate(
            chunk, st.ba[0], st.bg[0], cfg.imu)),
        ("IMU factors (_imu_local)", lambda: pnp_mod._imu_local(
            win.preints, st, grav, pre_mod.sqrt_information(win.preints))),
    ]
    for name, fn in paths:
        fn()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        aten = [e for e in prof.events() if e.name.startswith("aten::")]
        top = sum(1 for e in aten if e.cpu_parent is None)
        print(f"{name}: {top} top-level aten calls, {len(aten)} in all")


if __name__ == "__main__":
    main()
