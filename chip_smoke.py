"""Smoke run of the SfM engine on one NVIDIA GPU, through its public entry
points, at the scale the repository supports.

    python -u chip_smoke.py              # phases 1-6 on one card
    python -u chip_smoke.py --devices 4  # only the multi-device checks

Phases (one card): 1 device and settings; 2 minimal solvers in f32 vs a
CPU reference; 3 bundle adjustment at Notre-Dame scale (553 cameras, 50k
tracks, 300k observations) plus a small-problem comparison with CPU f64;
4 the global pipeline at Notre-Dame scale; 5 two-view verification ->
global reconstruction on an 11-view Strecha-sized scene; 6 the descriptor
matcher (fused kernel vs the XLA reference, 4096x4096x128, 8 pairs).

Each phase prints one line: its name, wall seconds of its first run
(compilation included) and its check values. A failed check raises and
the script exits non-zero. The CPU references run in a child process
(`JAX_PLATFORMS=cpu`) that never touches the card; the script waits for
all of its values before the first timed phase. The script refuses to
run where JAX finds no GPU. The last line is one JSON object naming the
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Median camera-position error (scene units, ring radius 10) of
# `synthetic_global.run(V=553, T=50_000, seed=0)` on the CPU backend in
# f32 (553/553 views); phase 4 allows the card twice this.
CPU_GLOBAL_553_MEDIAN_POS_ERR = 0.0028955568559467793

# Phase 2: the card's f32 recovery count may trail the CPU's f32 count on
# the same samples by this many (eigh/SVD come from cuSOLVER there, LAPACK
# here, and samples near the recovery tolerance can flip either way).
SOLVER_MARGIN = 8
# Recovery tolerances: five-point, max-abs distance to the true unit-norm
# essential matrix (up to sign); P3P, max-abs rotation plus translation
# error.
FIVE_POINT_TOL = 5e-3
P3P_TOL = 1e-3
# Phase 3: final cost within this fraction of the noise floor.
NOISE_FLOOR_BAND = 0.05
FOCAL_TOL = 1e-3
# Phase 3, small problem: card f32 vs CPU f64 final cost, relative. On the
# CPU, f32 and f64 land within ~1e-6 of each other at V=64, T=5k; the
# GPU's other reduction order (atomics in scatter-adds) adds noise of the
# same size, and the rest is room for one LM step accepted differently.
SMALL_BA_RTOL = 1e-4
# Phase 5: median camera-centre error after Sim(3) alignment, relative to
# the camera ring's radius.
VERIFY_ATE_REL = 1e-3


def log(line: str) -> None:
    print(line, flush=True)


def report(name: str, seconds: float, **checks) -> None:
    log(f"phase {name}: {seconds:.3f} s {json.dumps(checks, default=float)}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    """Card name and power limit as nvidia-smi prints them (a child
    process that does not import JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------------------
# CPU reference child


class CpuReference:
    """A `--cpu-reference` child on the CPU backend; it prints one JSON
    object per line ({"key": ..., "value": ...}) as each result is ready."""

    def __init__(self, seed: int, n_samples: int, small_ba: tuple[int, int]):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_PYTHON_CLIENT_MEM_FRACTION", None)
        # No persistent cache for the child: XLA:CPU executables cached on
        # one host may use instructions another host lacks.
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        self.proc = subprocess.Popen(
            [
                sys.executable, "-u", os.path.join(REPO, "chip_smoke.py"),
                "--cpu-reference", "--seed", str(seed),
                "--samples", str(n_samples),
                "--small-ba", f"{small_ba[0]},{small_ba[1]}",
            ],
            stdout=subprocess.PIPE, text=True, env=env, cwd=REPO,
        )
        self.values: dict = {}

    def get(self, key: str):
        while key not in self.values:
            line = self.proc.stdout.readline()
            if not line:
                rc = self.proc.wait()
                raise RuntimeError(f"CPU reference exited ({rc}) before {key!r}")
            if line.startswith("{"):
                item = json.loads(line)
                self.values[item["key"]] = item["value"]
        return self.values[key]

    def collect(self) -> None:
        """Read every value and wait for the child to exit, so that no
        timed phase shares the host with it."""
        for key in ("solvers_f32", "solvers_f64", "small_ba_f64"):
            self.get(key)
        rc = self.proc.wait()
        check(rc == 0, f"CPU reference exited {rc}")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def cpu_reference_main(seed: int, n_samples: int, small_ba: tuple[int, int]):
    import jax

    def emit(key, value):
        print(json.dumps({"key": key, "value": value}), flush=True)

    check(jax.default_backend() == "cpu", "CPU reference must run on the CPU")
    emit("solvers_f32", solver_recoveries(n_samples, seed, np.float32))
    jax.config.update("jax_enable_x64", True)
    emit("solvers_f64", solver_recoveries(n_samples, seed, np.float64))
    emit("small_ba_f64", small_ba_costs(*small_ba, dtype=np.float64))


# ---------------------------------------------------------------------------
# Phase 1: device


def phase_device() -> dict:
    import jax

    from pytheiasfm_tpu.utils.cache import enable_persistent_cache

    t0 = time.perf_counter()
    cache_dir = enable_persistent_cache()
    precision = jax.config.jax_default_matmul_precision
    check(precision == "float32", f"matmul precision is {precision!r}")
    out = dict(
        devices=[str(d) for d in jax.devices()],
        backend=jax.default_backend(),
        matmul_precision=precision,
        compile_cache=cache_dir,
    )
    report("device", time.perf_counter() - t0, **out)
    return out


# ---------------------------------------------------------------------------
# Phase 2: minimal solvers


def _rotations(aa):
    """Rodrigues: angle-axis [B, 3] -> rotation matrices [B, 3, 3]."""
    th = np.linalg.norm(aa, axis=-1)[:, None, None]
    k = aa / np.maximum(np.linalg.norm(aa, axis=-1, keepdims=True), 1e-300)
    K = np.zeros((len(aa), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K -= np.swapaxes(K, 1, 2)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def solver_samples(n: int, num_points: int, seed: int):
    """Random relative poses with `num_points` normalized correspondences
    each (the minimal-solver test harness of tests/test_minimal_solvers.py).
    Returns (x1, x2, R, t, E_gt, pts) in f64."""
    rng = np.random.default_rng(seed)
    R = _rotations(rng.normal(size=(n, 3)) * 0.3)
    t = rng.normal(size=(n, 3))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    pts = rng.uniform(-1, 1, size=(n, num_points, 3)) + np.asarray([0, 0, 4.0])
    x1 = pts[..., :2] / pts[..., 2:3]
    p2 = np.einsum("bij,bnj->bni", R, pts) + t[:, None, :]
    x2 = p2[..., :2] / p2[..., 2:3]
    tx = np.zeros((n, 3, 3))
    tx[:, 0, 1], tx[:, 0, 2], tx[:, 1, 2] = -t[:, 2], t[:, 1], -t[:, 0]
    tx -= np.swapaxes(tx, 1, 2)
    E_gt = tx @ R
    E_gt /= np.linalg.norm(E_gt, axis=(1, 2), keepdims=True)
    return x1, x2, R, t, E_gt, pts


def solver_recoveries(n: int, seed: int, dtype) -> dict:
    """Ground-truth recoveries of `ops.five_point` and `ops.p3p` over `n`
    random minimal samples each, computed in `dtype` on the default
    backend."""
    import jax
    import jax.numpy as jnp

    from pytheiasfm_tpu.ops import five_point, p3p

    x1, x2, _, _, E_gt, _ = solver_samples(n, 5, seed)
    E, valid = jax.jit(five_point.five_point_relative_pose)(
        jnp.asarray(x1, dtype), jnp.asarray(x2, dtype)
    )
    E, valid = np.asarray(E, np.float64), np.asarray(valid)
    dist = np.minimum(
        np.abs(E - E_gt[:, None]).max(axis=(2, 3)),
        np.abs(E + E_gt[:, None]).max(axis=(2, 3)),
    )
    five = int(np.sum(np.min(np.where(valid, dist, np.inf), axis=1) < FIVE_POINT_TOL))

    _, x2, R, t, _, pts = solver_samples(n, 3, seed + 1)
    Rs, ts, valid = jax.jit(p3p.pose_from_three_points)(
        jnp.asarray(x2, dtype), jnp.asarray(pts, dtype)
    )
    Rs, ts = np.asarray(Rs, np.float64), np.asarray(ts, np.float64)
    err = (
        np.abs(Rs - R[:, None]).max(axis=(2, 3))
        + np.abs(ts - t[:, None]).max(axis=2)
    )
    three = int(np.sum(np.min(np.where(np.asarray(valid), err, np.inf), axis=1) < P3P_TOL))
    return {"five_point": five, "p3p": three, "samples": n}


def phase_minimal_solvers(cpu: CpuReference, n: int = 256, seed: int = 0) -> dict:
    import jax

    t0 = time.perf_counter()
    dev = solver_recoveries(n, seed, np.float32)
    t_dev = time.perf_counter() - t0
    ref32 = cpu.get("solvers_f32")
    ref64 = cpu.get("solvers_f64")
    for k in ("five_point", "p3p"):
        check(
            dev[k] >= ref32[k] - SOLVER_MARGIN,
            f"{k}: {dev[k]}/{n} on {jax.default_backend()} vs "
            f"{ref32[k]}/{n} on CPU f32 (margin {SOLVER_MARGIN})",
        )
    out = dict(device_f32=dev, cpu_f32=ref32, cpu_f64=ref64, margin=SOLVER_MARGIN)
    report("minimal_solvers", t_dev, **out)
    return out


# ---------------------------------------------------------------------------
# Phase 3: bundle adjustment


def noise_floor(prob, extra_params: int = 0, sigma: float = 0.5) -> float:
    """Expected final cost 0.5 * sum(r^2) at the optimum of a problem whose
    observations carry Gaussian noise `sigma` px on both coordinates:
    0.5 * sigma^2 * (2 * O_valid - free parameters)."""
    O = int(np.sum(np.asarray(prob["obs_mask"])))
    params = 6 * int(np.sum(np.asarray(prob["camera_free"]))) + 3 * prob["T"]
    return 0.5 * sigma**2 * (2 * O - params - extra_params)


def small_ba_costs(V: int, T: int, dtype=np.float32) -> dict:
    """Final costs of the two BA configurations on a small problem."""
    import bench

    prob = bench.build_problem(V=V, T=T, dtype=dtype)
    _, _, dense = bench.dense_ba_runner(prob)()
    free, _ = bench.free_intrinsics_ba_runner(prob)()
    return {"dense": float(dense.final_cost), "free": float(free.final_cost)}


def phase_bundle_adjustment(
    cpu: CpuReference, V: int = 553, T: int = 50_000,
    small: tuple[int, int] = (64, 5_000),
) -> dict:
    import bench

    t0 = time.perf_counter()
    prob = bench.build_problem(V=V, T=T)
    floor = noise_floor(prob)
    t1 = time.perf_counter()
    _, _, dense = bench.dense_ba_runner(prob)()
    t_dense = time.perf_counter() - t1
    t1 = time.perf_counter()
    free, focal = bench.free_intrinsics_ba_runner(prob)()
    t_free = time.perf_counter() - t1
    small_dev = small_ba_costs(*small)
    seconds = time.perf_counter() - t0
    small_ref = cpu.get("small_ba_f64")

    out = dict(
        V=V, T=T, O_valid=int(np.sum(np.asarray(prob["obs_mask"]))),
        noise_floor=floor,
        dense_s=t_dense, dense_initial_cost=float(dense.initial_cost),
        dense_final_cost=float(dense.final_cost),
        free_s=t_free, free_final_cost=float(free.final_cost),
        recovered_focal=focal,
        small=dict(V=small[0], T=small[1], device_f32=small_dev, cpu_f64=small_ref),
    )
    for k in ("dense", "free"):
        ratio = out[f"{k}_final_cost"] / floor
        check(
            abs(ratio - 1.0) < NOISE_FLOOR_BAND,
            f"{k} BA final cost {out[f'{k}_final_cost']} is {ratio:.4f}x the "
            f"noise floor {floor}",
        )
        rel = abs(small_dev[k] - small_ref[k]) / small_ref[k]
        check(
            rel < SMALL_BA_RTOL,
            f"small {k} BA: device {small_dev[k]} vs CPU f64 {small_ref[k]} "
            f"(rel {rel:.2e})",
        )
    check(
        abs(focal / 1000.0 - 1.0) < FOCAL_TOL,
        f"free-focal BA recovered focal {focal}, truth 1000",
    )
    report("bundle_adjustment", seconds, **out)
    return out


# ---------------------------------------------------------------------------
# Phase 4: global pipeline


def phase_global_pipeline(
    V: int = 553, T: int = 50_000, cpu_median: float | None = None,
) -> dict:
    from pytheiasfm_tpu.pipelines import synthetic_global as sg

    cpu_median = CPU_GLOBAL_553_MEDIAN_POS_ERR if cpu_median is None else cpu_median
    t0 = time.perf_counter()
    r = sg.run(V=V, T=T, seed=0)
    seconds = time.perf_counter() - t0
    check(r["views"] == V, f"{r['views']}/{V} views estimated")
    check(
        r["median_pos_err"] <= 2.0 * cpu_median,
        f"median position error {r['median_pos_err']} > 2 x CPU {cpu_median}",
    )
    out = {k: r[k] for k in (
        "views", "edges", "observations", "median_pos_err", "t_build_s",
        "t_rotation_s", "t_position_s", "t_triangulation_s", "t_ba_s",
        "t_total_s",
    )}
    out["cpu_median_pos_err"] = cpu_median
    report("global_pipeline", seconds, **out)
    return out


# ---------------------------------------------------------------------------
# Phase 5: verification -> reconstruction


def phase_verify_reconstruct(
    num_views: int = 11, num_tracks: int = 5_000, seed: int = 0,
) -> dict:
    """11 views on a ring of radius 10 at the Strecha fountain-11 image size
    (3072x2048, focal 2759.48 px), 0.5 px noise: batched RANSAC five-point
    verification + two-view BA builds the view graph, then the global
    estimator reconstructs it."""
    from pytheiasfm_tpu.pipelines import fountain
    from pytheiasfm_tpu.transforms.alignment import align_point_clouds_umeyama
    from pytheiasfm_tpu.utils.synthetic import SyntheticSceneOptions, generate_scene

    opts = SyntheticSceneOptions(
        num_views=num_views, num_tracks=num_tracks, focal_length=2759.48,
        image_width=3072, image_height=2048, pixel_noise=0.5, seed=seed,
    )
    t0 = time.perf_counter()
    recon, gt_ext, _ = generate_scene(opts)
    recon = fountain.strip_geometry(recon)
    t1 = time.perf_counter()
    graph = fountain.build_view_graph(recon, seed=seed)
    t_verify = time.perf_counter() - t1
    t1 = time.perf_counter()
    summary = fountain.run_estimator(recon, graph, "global", seed)
    t_sfm = time.perf_counter() - t1
    seconds = time.perf_counter() - t0

    est = [v for v in range(recon.num_views()) if recon.view_estimated[v]]
    check(bool(summary.success), "global estimator reported failure")
    check(len(est) == num_views, f"{len(est)}/{num_views} cameras estimated")
    c_est = np.asarray(recon.view_extrinsics[est, :3], np.float64)
    c_gt = gt_ext[est, :3]
    R, t, s = align_point_clouds_umeyama(c_est, c_gt)
    aligned = float(s) * c_est @ np.asarray(R, np.float64).T + np.asarray(t)
    err = np.linalg.norm(aligned - c_gt, axis=-1) / opts.camera_radius
    out = dict(
        cameras=len(est), edges=graph.num_edges(),
        observations=recon.num_observations(),
        median_ate_rel=float(np.median(err)), max_ate_rel=float(np.max(err)),
        bound=VERIFY_ATE_REL, t_verify_s=t_verify, t_sfm_s=t_sfm,
    )
    check(
        out["median_ate_rel"] < VERIFY_ATE_REL,
        f"median ATE {out['median_ate_rel']} of the ring radius",
    )
    report("verify_reconstruct", seconds, **out)
    return out


# ---------------------------------------------------------------------------
# Phase 6: descriptor matcher


def padded_matcher_inputs(n_desc: int, dim: int, pairs: int, seed: int):
    """`bench.matcher_descriptors` with a tail of rows (7) and columns (3)
    zeroed and masked off, as `matching/matcher.py` pads each image to a
    power of two. Returns (d1, d2, mask1, mask2, perm)."""
    import bench

    d1, d2, perm = bench.matcher_descriptors(n_desc, dim, pairs, seed)
    m1 = np.ones((pairs, n_desc), bool)
    m2 = np.ones((pairs, n_desc), bool)
    m1[:, -7:] = False
    m2[:, -3:] = False
    d1[~m1] = 0.0
    d2[~m2] = 0.0
    return d1, d2, m1, m2, perm


def matcher_parity(d1, d2, m1, m2, perm, expected: str) -> dict:
    """Match one batch through `match_descriptors_batch_auto` and the XLA
    reference; check the recorded choice, their agreement, the masks and
    the true matches."""
    import jax.numpy as jnp

    from pytheiasfm_tpu.matching.brute_force import (
        choose_matcher,
        match_descriptors_batch,
        match_descriptors_batch_auto,
    )
    from pytheiasfm_tpu.utils import counters

    args = [jnp.asarray(a) for a in (d1, d2, m1, m2)]
    ratio = jnp.asarray(0.8, jnp.float32)
    counters.reset()
    idx_a, dist_a = match_descriptors_batch_auto(*args, ratio)
    idx_a, dist_a = np.asarray(idx_a), np.asarray(dist_a)
    choice = counters.snapshot()
    check(
        choice == {f"matcher_{expected}": 1}
        and choose_matcher(d1.shape[1]) == expected,
        f"auto matcher chose {choice}, expected {expected}",
    )
    idx_x, dist_x = match_descriptors_batch(*args, ratio)
    idx_x, dist_x = np.asarray(idx_x), np.asarray(dist_x)
    agree = float(np.mean(idx_a == idx_x))
    check(agree >= 0.99, f"match agreement {agree}")
    sel = (idx_a == idx_x) & (idx_x >= 0)
    np.testing.assert_allclose(dist_a[sel], dist_x[sel], rtol=1e-3, atol=1e-4)

    matched = idx_a >= 0
    check(not matched[~m1].any(), "a masked row was matched")
    hit = np.take_along_axis(m2, np.maximum(idx_a, 0), axis=1)
    check(hit[matched].all(), "a row was matched to a masked column")
    live = m1 & np.take_along_axis(m2, perm, axis=1)
    recall = float(np.mean(matched[live]))
    correct = float(np.mean(idx_a[matched] == perm[matched]))
    check(recall > 0.9 and correct > 0.99, f"recall {recall}, correct {correct}")
    return dict(
        shape=list(d1.shape), choice=choice, match_agreement=agree,
        recall=recall, correct=correct,
        max_dist_delta=float(np.max(np.abs(dist_a[sel] - dist_x[sel]))),
    )


def phase_matcher(
    n_desc: int = 4096, dim: int = 128, pairs: int = 8, reps: int = 20,
    seed: int = 0, card: str = "",
) -> dict:
    """The matcher on pipeline-shaped input (masked, zero-padded tails) at
    full size, and on a small batch whose D (40) the kernel pads to 64;
    then both matchers timed on the full batch."""
    import jax
    import jax.numpy as jnp

    import bench
    from pytheiasfm_tpu.matching.brute_force import match_descriptors_batch
    from pytheiasfm_tpu.matching.pallas_matcher import (
        match_descriptors_batch_pallas,
    )

    interpret = jax.default_backend() == "cpu"
    expected = "xla" if interpret else "triton"
    t0 = time.perf_counter()
    d1, d2, m1, m2, perm = padded_matcher_inputs(n_desc, dim, pairs, seed)
    full = matcher_parity(d1, d2, m1, m2, perm, expected)
    small = matcher_parity(
        *padded_matcher_inputs(max(128, n_desc // 4), 40, 2, seed + 1),
        expected,
    )
    seconds = time.perf_counter() - t0

    d1, d2, m1, m2 = (jnp.asarray(a) for a in (d1, d2, m1, m2))
    ratio = jnp.asarray(0.8, jnp.float32)

    def kernel(a, b):
        return match_descriptors_batch_pallas(
            a, b, m1, m2, ratio, interpret=interpret
        )

    def xla(a, b):
        return match_descriptors_batch(a, b, m1, m2, ratio)

    dt_kernel = bench.matcher_seconds_per_call(kernel, d1, d2, reps)
    dt_xla = bench.matcher_seconds_per_call(xla, d1, d2, reps)
    out = dict(
        **full, padded_dim=small,
        kernel_pairs_per_s=pairs / dt_kernel, xla_pairs_per_s=pairs / dt_xla,
        kernel_ms=dt_kernel * 1e3, xla_ms=dt_xla * 1e3, card=card,
    )
    report("matcher", seconds, **out)
    return out


# ---------------------------------------------------------------------------
# --devices N


def phase_multi_device(n: int) -> dict:
    """The sharded paths of `__graft_entry__.dryrun_multichip` on an
    n-device mesh, each asserted against its single-device run:
    observation-sharded BA step, dense-Schur shard_map psum, the f64
    public `options.mesh` entry, and sharded rotation averaging / LUD /
    triangulation / scan-chunked BA on a 1024-view scene."""
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n)
    out = dict(devices=n, agreement="all sharded phases match single device")
    report(f"multi_device_{n}", time.perf_counter() - t0, **out)
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: phases 1-6 on one card; N > 1: only the "
                    "multi-device checks on N cards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-reference", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--samples", type=int, default=256, help=argparse.SUPPRESS)
    ap.add_argument("--small-ba", default="64,5000", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    small = tuple(int(x) for x in args.small_ba.split(","))
    if args.cpu_reference:
        sys.path.insert(0, REPO)
        cpu_reference_main(args.seed, args.samples, small)
        return 0

    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: JAX found no GPU (backend {jax.default_backend()!r})",
            file=sys.stderr,
        )
        return 2
    if len(jax.devices()) < args.devices:
        print(
            f"chip_smoke: {args.devices} devices asked, "
            f"{len(jax.devices())} found",
            file=sys.stderr,
        )
        return 2

    t_start = time.perf_counter()
    card = nvidia_smi()
    if args.devices > 1:
        from pytheiasfm_tpu.utils.cache import enable_persistent_cache

        enable_persistent_cache()
        log(f"devices: {jax.devices()}")
        log(card)
        phase_multi_device(args.devices)
    else:
        cpu = CpuReference(args.seed, args.samples, small)
        try:
            log(card)
            phase_device()
            t0 = time.perf_counter()
            cpu.collect()
            log(f"cpu_reference: {time.perf_counter() - t0:.3f} s waited, "
                "before the timed phases")
            phase_minimal_solvers(cpu, args.samples, args.seed)
            phase_bundle_adjustment(cpu, small=small)
            phase_global_pipeline()
            phase_verify_reconstruct(seed=args.seed)
            phase_matcher(seed=args.seed, card=card)
        finally:
            cpu.close()
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
