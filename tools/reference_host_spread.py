"""How far each package's lockstep scenes move with the host's instruction
set, on the CPU: the witness behind ROADMAP item 31 and the lockstep
tests' carried priors.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/reference_host_spread.py \
        [--scenes stream,loop,...] [--settings base,jax_AVX2,...] \
        [--jobs 4] [--tree DIR] [--carry every|bootstrap] [--out FILE]

Each scene is the fixture of a lockstep test file of the tree given
(default: this one), imported from its tests/ and run as the test runs
it; whatever that fixture carries between the packages, the scene
carries (--carry bootstrap: only the bootstrap prior, the reference
forming its later priors itself, where its records stay empty):
  stream    tests/test_torch_stream.py (test_torch_stream_matches_jax_
            per_frame, test_bootstrap_prior_matches_jax_information)
  loop      tests/test_torch_stream_loop.py (..._matches_jax_per_frame)
  depth2    tests/test_torch_stream_depth2.py (both per-frame tests)
  recovery  tests/test_torch_recovery.py (the interactive and the
            streamed failure)
  backend   tests/test_torch_backend.py::test_backend_step_matches_jax's
            step, and the reference's step again with the observations
            moved by N(0, 1e-6) (normalized, 2e-4 px) in 7 draws
  k1        tests/test_torch_klt_domain.py::test_k1_unconverged_slots_
            spread_in_the_reference at (21, 5): the Pallas kernel in
            interpret mode and the port's plain version against the plain
            version in float64
  shipped   tests/test_torch_stream_shipped.py (klt_eps 0.01, (21, 3),
            the JAX package's Pallas kernels in interpret mode; about 4
            minutes)
  shipped_window  tests/test_torch_stream_shipped_window.py ((15, 4))
Every scene runs in one child process per setting: the JAX package with
XLA_FLAGS=--xla_cpu_max_isa= AVX2 and SSE4_2 (the port at its default),
the port with ATEN_CPU_CAPABILITY=avx2 and default (no vector unit;
MKL_ENABLE_INSTRUCTIONS=AVX2 / SSE4_2 beside it, JAX at its default), and
the base run with neither cap. The rendered frames come from
tests/.render_cache, so every child reads the same ones (render them
first, e.g. by running the tests once).

Prints one JSON line per scene and setting: for each package, every
frame's position and rotation spread against that package's own base run
(the largest, and the first frame past 5e-3); every prior's branch of
_info_to_sqrt (ridge, ridge_100x, past_both: the reference's NaN, the
port's eigen fallback) and the least eigenvalue of the information it
factorizes beside its ridge; where the scene's test first parts the
two packages (frame, what parted, and the priors each had formed by
then); and for the priors the lockstep carries into the reference
(test_torch_stream.carry_priors), kept and discarded apart, the largest
gap of each to the reference's own prior of the same inputs (JᵀJ and
Jᵀr, check_carried_priors' measure) and of its Schur complement to the
float64 one, scaled by the diagonal of the complement and of the kept
block before the elimination (test_torch_stream._schur_gap). --out
writes every child's raw record as one JSON file.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("stream", "loop", "depth2", "recovery", "backend", "k1",
          "shipped", "shipped_window")
SETTINGS = {
    "base": {},
    "jax_AVX2": {"XLA_FLAGS": "--xla_cpu_max_isa=AVX2"},
    "jax_SSE4_2": {"XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2"},
    "port_avx2": {"ATEN_CPU_CAPABILITY": "avx2",
                  "MKL_ENABLE_INSTRUCTIONS": "AVX2"},
    "port_scalar": {"ATEN_CPU_CAPABILITY": "default",
                    "MKL_ENABLE_INSTRUCTIONS": "SSE4_2"},
}
TOL_M = TOL_RAD = 5e-3          # the lockstep's per-frame bounds
RAW_TOL_M = 1e-2                # test_torch_stream_depth2.py's raw poses


# --------------------------------------------------------------------------
# Child: one scene under one setting.
# --------------------------------------------------------------------------

def _record_priors(rec):
    """Wrap both packages' _info_to_sqrt so that each call appends
    (branch, least eigenvalue, ridge) to rec["priors_j"] / ["priors_t"];
    the JAX side through a host callback inside its jitted code."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from vins_tpu.core import marginalization as j_marg
    from vins_tpu_torch.core import marginalization as t_marg

    names = ("ridge", "ridge_100x", "past_both")
    name = lambda a, b: names[0 if a else 1 if b else 2]
    least = lambda Hs: (float(np.linalg.eigvalsh(Hs)[0])
                        if np.all(np.isfinite(Hs)) else float("nan"))
    j_inner, t_inner = j_marg._info_to_sqrt, t_marg._info_to_sqrt
    rec.update(priors_j=[], priors_t=[])

    def ref(H, g, eps, method="chol"):
        Hs = 0.5 * (H + H.T)
        I = jnp.eye(Hs.shape[0], dtype=Hs.dtype)
        ridge = eps + 1e-6 * jnp.max(jnp.abs(jnp.diagonal(Hs)))
        ok = [jnp.all(jnp.isfinite(jnp.linalg.cholesky(Hs + k * ridge * I)))
              for k in (1.0, 100.0)]
        jax.debug.callback(lambda a, b, Hs, r: rec["priors_j"].append(
            (name(bool(a), bool(b)), least(np.asarray(Hs, np.float64)),
             float(r))), *ok, Hs, ridge)
        return j_inner(H, g, eps, method)

    def port(H, g, eps, method="chol"):
        if not torch._C._functorch.is_batchedtensor(H):
            Hs = 0.5 * (H + H.T)
            I = torch.eye(Hs.shape[0], dtype=Hs.dtype)
            ridge = eps + 1e-6 * torch.max(torch.abs(torch.diagonal(Hs)))
            ok = [int(torch.linalg.cholesky_ex(Hs + k * ridge * I)[1]) == 0
                  for k in (1.0, 100.0)]
            rec["priors_t"].append((name(*ok), least(
                Hs.detach().double().numpy()), float(ridge)))
        return t_inner(H, g, eps, method)

    j_marg._info_to_sqrt, t_marg._info_to_sqrt = ref, port


def _frames(outs):
    import numpy as np
    return [dict(init=bool(o.initialized), kf=bool(o.is_keyframe),
                 status=str(o.status), n=int(o.n_tracked),
                 hit=bool(getattr(o, "loop_hit", False)),
                 p=np.asarray(o.p, np.float64).tolist(),
                 q=np.asarray(o.q, np.float64).tolist(),
                 p_raw=np.asarray(getattr(o, "p_raw", o.p),
                                  np.float64).tolist())
            for o in outs]


def _carried(rec, r):
    """The lockstep's carried priors (test_torch_stream.carry_priors):
    each later one's information gap to the reference's own of the same
    inputs, and each one's Schur complement gap to float64 (the
    bootstrap's first), with whether the system discarded it."""
    rec["carried"] = [list(c) for c in r["carried"]]
    rec["schur"] = [list(c) for c in r["schur"]]


def _scene_stream(rec, name="test_torch_stream"):
    import importlib
    import jax
    import numpy as np
    m = importlib.import_module(name)
    _, outs_j, outs_t, r = m.streams.__wrapped__()
    rec["frames_j"], rec["frames_t"] = _frames(outs_j), _frames(outs_t)
    rec["own_boot_prior_finite_j"] = [bool(np.all(np.isfinite(np.asarray(
        jax.device_get(e.prior.J))))) for e in r.get("j", [])]
    _carried(rec, r)


def _scene_shipped(rec):
    _scene_stream(rec, "test_torch_stream_shipped")


def _scene_shipped_window(rec):
    _scene_stream(rec, "test_torch_stream_shipped_window")


def _scene_loop(rec):
    import test_torch_stream_loop as m
    s = m.streams.__wrapped__()
    rec["frames_j"] = _frames(s["first_j"] + s["outs_j"])
    rec["frames_t"] = _frames(s["first_t"] + s["outs_t"])
    rec["carry_at"] = len(s["first_j"])
    _carried(rec, s["carried"])


def _scene_depth2(rec):
    import test_torch_stream_depth2 as m
    s = m.streams.__wrapped__()
    rec["frames_j"] = _frames(s["first_j"] + s["outs_j"])
    rec["frames_t"] = _frames(s["first_t"] + s["outs_t"])
    rec["carry_at"] = len(s["first_j"])
    rec["raw_tol"] = RAW_TOL_M
    _carried(rec, s["carried"])


def _scene_recovery(rec):
    import test_torch_recovery as m
    _, _, runs, prior_ok, _, c_i = m.interactive.__wrapped__()
    n_i = len(rec["priors_j"]), len(rec["priors_t"])
    (_, outs_j), (_, outs_t) = runs
    _, _, bad, sj, st, *_, c_s = m.streamed.__wrapped__()
    _carried(rec, dict(carried=c_i["carried"] + c_s["carried"],
                       schur=c_i["schur"] + c_s["schur"]))
    rec["frames_j"] = _frames(outs_j) + _frames(sj)
    rec["frames_t"] = _frames(outs_t) + _frames(st)
    rec["parts"] = dict(interactive=[0, len(outs_j)],
                        streamed=[len(outs_j), len(outs_j) + len(sj)])
    rec["interactive_priors"] = n_i
    rec["reinit_prior_finite_j"] = prior_ok


def _scene_backend(rec):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    import test_torch_backend as m
    from vins_tpu.core import estimator as j_est
    from vins_tpu_torch import interop
    from vins_tpu_torch.core import estimator as t_est
    from vins_tpu_torch.core import preintegration as t_pre

    w = m.win.__wrapped__()
    est_j, est_t = m.booted.__wrapped__(w)
    w = w[0]
    est_t = interop.to_torch(jax.device_get(est_j), est_t)
    F, M = m.F, m.M
    step = jax.jit(lambda e, i: j_est.backend_step(e, i, m.CFG, w.ext,
                                                   w.gravity))

    def inp_j(obs):
        return j_est.FrameInput(
            chunk=jax.tree.map(lambda x: x[-1], w.chunks),
            ids=w.feats.track_id, obs=obs,
            obs_valid=w.feats.mask[F - 1] & w.feats.valid,
            loop=j_est.LoopInput.inactive(M))

    def stats(out):
        s = out.stats
        return dict(accepted=int(s.accepted_iters),
                    final_cost=float(s.final_cost),
                    final_lambda=float(getattr(s, "final_lambda",
                                               float("nan"))),
                    pose_p=np.asarray(out.pose_p, np.float64).tolist())

    obs = np.asarray(w.feats.obs[F - 1])
    _, out_j = step(est_j, inp_j(jnp.asarray(obs)))
    ij = inp_j(jnp.asarray(obs))
    inp_t = t_est.FrameInput(
        chunk=interop.to_torch(jax.device_get(ij.chunk),
                               t_pre.ImuChunk.empty(
                                   m.CFG.window.max_imu_per_edge)),
        ids=torch.as_tensor(np.array(ij.ids)),
        obs=torch.as_tensor(np.array(ij.obs)),
        obs_valid=torch.as_tensor(np.array(ij.obs_valid)),
        loop=t_est.LoopInput.inactive(M))
    _, out_t = t_est.backend_step(est_t, inp_t, m.TCFG, m.est_t_ext(w),
                                  torch.as_tensor(np.array(w.gravity)))
    rec["step_j"], rec["step_t"] = stats(out_j), stats(out_t)
    rng = np.random.default_rng(0)
    rec["draws_j"] = [stats(step(est_j, inp_j(jnp.asarray(
        obs + 1e-6 * rng.standard_normal(obs.shape).astype(np.float32))))[1])
        for _ in range(7)]


def _scene_k1(rec):
    import numpy as np
    import torch
    import test_torch_klt_domain as m
    from vins_tpu_torch import default_config
    from vins_tpu_torch.ops import klt_cuda

    jx = m.jx.__wrapped__()
    c = m._chip_smoke()
    win, L = 21, 5
    pyr0, g0, pyr1, _, pts, valid, _ = c.frame_pair(
        c._with_window(default_config(), win, L), "cpu")
    runs = []
    p, ok, _ = klt_cuda.track_pyramid_plain(pyr0, g0, pyr1, pts, valid, win,
                                            m.ITERS, m.EPS, iters_run=runs)
    f64 = lambda xs: [x.double() for x in xs]
    p64, _, _ = klt_cuda.track_pyramid_plain(
        f64(pyr0), [tuple(f64(g)) for g in g0], f64(pyr1), pts.double(),
        valid, win, m.ITERS, m.EPS)
    j = lambda x: jx.jnp.asarray(x.numpy())
    with jx.pltpu.force_tpu_interpret_mode():
        p_ref, _, _ = jx.pallas.track_pyramid_pallas(
            [j(x) for x in pyr0], [(j(a), j(b)) for a, b in g0],
            [j(x) for x in pyr1], j(pts), j(valid), win, m.ITERS, m.EPS)
    unconv = (ok & (runs[-1] == m.ITERS)).numpy()
    conv = (ok & (runs[-1] < m.ITERS)).numpy()
    d = lambda a, b: np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max(-1)
    top = lambda x, s: float(x[s].max()) if s.any() else 0.0
    p64 = p64.numpy()
    rec["k1"] = dict(
        n_unconverged=int(unconv.sum()),
        pallas_to_plain=dict(converged=top(d(p_ref, p.numpy()), conv),
                             unconverged=top(d(p_ref, p.numpy()), unconv)),
        pallas_to_float64=top(d(p_ref, p64), unconv),
        plain_to_float64=top(d(p.numpy(), p64), unconv),
        pallas_flow=np.asarray(p_ref, np.float64)[unconv].tolist())


def _carry_bootstrap_only() -> None:
    """test_torch_stream.carry_priors as the scenes' test files call it,
    with the reference's own marginalizations restored after it: the
    lockstep carries only the bootstrap prior (PR 13's carry)."""
    import test_torch_stream as m
    from vins_tpu.core import marginalization as j_marg
    carry = m.carry_priors
    own = {k: getattr(j_marg, k)
           for k in ("marginalize_old", "marginalize_second_new")}

    def bootstrap_only(mp, *args):
        rec = carry(mp, *args)
        for k, f in own.items():
            mp.setattr(j_marg, k, f)
        return rec

    for name in ("test_torch_stream", "test_torch_stream_loop",
                 "test_torch_stream_depth2", "test_torch_recovery"):
        mod = __import__(name)
        if hasattr(mod, "carry_priors"):
            mod.carry_priors = bootstrap_only


def child(scene: str, tree: str, out: str, carry: str) -> None:
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    import conftest  # noqa: F401  (the CPU mesh and the render cache)
    import torch
    torch.set_num_threads(1)
    if carry == "bootstrap":
        _carry_bootstrap_only()
    rec = dict(scene=scene)
    if scene not in ("k1",):
        _record_priors(rec)
    t0 = time.time()
    globals()["_scene_" + scene](rec)
    rec["seconds"] = time.time() - t0
    with open(out, "w") as f:
        json.dump(rec, f)


# --------------------------------------------------------------------------
# Parent: the children, and what they show.
# --------------------------------------------------------------------------

def _rot(qa, qb) -> float:
    import numpy as np
    qa, qb = np.asarray(qa), np.asarray(qb)
    d = abs(float(qa @ qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb))
    return float(2.0 * np.arccos(min(d, 1.0)))


def _spread(fa, fb) -> dict:
    """Per-frame position / rotation distance of run b from run a (same
    package), over frames both publish."""
    import numpy as np
    rows = [(k, float(np.abs(np.subtract(a["p"], b["p"])).max()),
             _rot(a["q"], b["q"]))
            for k, (a, b) in enumerate(zip(fa, fb))
            if a["init"] and b["init"]]
    first = next((k for k, dp, dr in rows if dp > TOL_M or dr > TOL_RAD),
                 None)
    same = sum((a["init"], a["kf"], a["status"]) != (b["init"], b["kf"],
                                                     b["status"])
               for a, b in zip(fa, fb))
    return {"max_m": max((r[1] for r in rows), default=0.0),
            "max_rad": max((r[2] for r in rows), default=0.0),
            "first_past_5e-3": first, "decisions_differ": same}


def _parting(rec) -> dict:
    """The first frame where the scene's test parts the two packages: a
    decision, n_tracked by more than 2, or a pose past its bound."""
    import numpy as np
    raw_tol = rec.get("raw_tol")
    worst = dict(m=0.0, rad=0.0)
    for k, (a, b) in enumerate(zip(rec["frames_j"], rec["frames_t"])):
        if (a["init"], a["kf"], a["status"], a["hit"]) != \
                (b["init"], b["kf"], b["status"], b["hit"]):
            return dict(frame=k, what="decision", **worst)
        if abs(a["n"] - b["n"]) > 2:
            return dict(frame=k, what="n_tracked", **worst)
        if not a["init"]:
            continue
        dp = float(np.abs(np.subtract(a["p"], b["p"])).max())
        dr = _rot(a["q"], b["q"])
        draw = float(np.abs(np.subtract(a["p_raw"], b["p_raw"])).max())
        worst = dict(m=max(worst["m"], dp), rad=max(worst["rad"], dr))
        if dp > TOL_M:
            return dict(frame=k, what=f"position {dp:.4g} m", **worst)
        if dr > TOL_RAD:
            return dict(frame=k, what=f"rotation {dr:.4g} rad", **worst)
        if raw_tol is not None and draw > raw_tol:
            return dict(frame=k, what=f"raw position {draw:.4g} m", **worst)
    return dict(frame=None, what="none", **worst)


def _gaps(rows, names) -> dict:
    """The largest of each gap (rows: kind, the gaps, discarded) of the
    priors the system keeps and of those it discards, with their
    counts."""
    out = {}
    for part, keep in (("kept", False), ("discarded", True)):
        sel = [r for r in rows if bool(r[-1]) == keep]
        out[part] = dict(n=len(sel), **{
            name: max((r[1 + i] for r in sel), default=None)
            for i, name in enumerate(names)})
    return out


def _priors_text(priors) -> list:
    return [f"{b} {lam:.3g}/{r:.3g}" for b, lam, r in priors]


def report(scene: str, runs: dict) -> None:
    base = runs["base"]
    for setting, rec in runs.items():
        line = dict(scene=scene, setting=setting,
                    seconds=round(rec.get("seconds", 0.0), 1))
        if "frames_j" in rec:
            if setting != "base":
                line["reference_spread"] = _spread(base["frames_j"],
                                                   rec["frames_j"])
                line["port_spread"] = _spread(base["frames_t"],
                                              rec["frames_t"])
            line["parts_at"] = _parting(rec)
            for key in ("carry_at", "parts", "reinit_prior_finite_j",
                        "own_boot_prior_finite_j"):
                if key in rec:
                    line[key] = rec[key]
        if "carried" in rec:
            line["carried"] = _gaps(rec["carried"], ("H", "g"))
            line["schur_to_float64"] = _gaps(rec["schur"],
                                             ("H", "H_in", "g"))
        if "priors_j" in rec:
            line["priors_reference"] = _priors_text(rec["priors_j"])
            line["priors_port"] = _priors_text(rec["priors_t"])
        for key in ("step_j", "step_t"):
            if key in rec:
                line[key] = {k: v for k, v in rec[key].items()
                             if k != "pose_p"}
        if "draws_j" in rec:
            line["reference_draws_accepted"] = [d["accepted"]
                                                for d in rec["draws_j"]]
            line["reference_draws_cost"] = [d["final_cost"]
                                            for d in rec["draws_j"]]
        if "k1" in rec:
            k1 = dict(rec["k1"])
            flow = k1.pop("pallas_flow")
            if setting != "base":
                import numpy as np
                k1["pallas_to_base_pallas"] = float(np.abs(
                    np.subtract(flow, base["k1"]["pallas_flow"])).max()) \
                    if flow else 0.0
            line["k1"] = k1
        print(json.dumps(line), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--settings", default=",".join(SETTINGS))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out")
    ap.add_argument("--carry", choices=("every", "bootstrap"),
                    default="every")
    ap.add_argument("--child", nargs=2, metavar=("SCENE", "OUT"))
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    if a.child:
        child(a.child[0], tree, a.child[1], a.carry)
        return
    import tempfile
    work = tempfile.mkdtemp(prefix="host_spread_")
    jobs = [(s, k) for s in a.scenes.split(",")
            for k in a.settings.split(",")]

    def run(job):
        scene, setting = job
        out = os.path.join(work, f"{scene}_{setting}.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu", **SETTINGS[setting])
        if "XLA_FLAGS" in os.environ and "XLA_FLAGS" in SETTINGS[setting]:
            env["XLA_FLAGS"] = (os.environ["XLA_FLAGS"] + " "
                                + SETTINGS[setting]["XLA_FLAGS"])
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree, "--carry", a.carry,
                            "--child", scene, out],
                           env=env, capture_output=True, text=True)
        if r.returncode != 0:
            return job, dict(error=r.stderr[-2000:])
        with open(out) as f:
            return job, json.load(f)

    with ThreadPoolExecutor(a.jobs) as pool:
        done = dict(pool.map(run, jobs))
    for scene in a.scenes.split(","):
        runs = {k: done[(scene, k)] for k in a.settings.split(",")}
        bad = {k: v["error"].strip().splitlines()[-1]
               for k, v in runs.items() if "error" in v}
        if bad:
            print(json.dumps(dict(scene=scene, errors=bad)), flush=True)
        if "error" not in runs.get("base", {}):
            report(scene, {k: v for k, v in runs.items() if k not in bad})
    if a.out:
        with open(a.out, "w") as f:
            json.dump({f"{s}/{k}": v for (s, k), v in done.items()}, f)


if __name__ == "__main__":
    main()
