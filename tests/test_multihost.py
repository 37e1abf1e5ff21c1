"""Multi-host story: explicit-collectives BA path + 2-process mesh.

SURVEY §7.9: scale-out = mesh over (hosts x chips). Covered here:
  - the dense-Schur kernel's explicit shard_map path (collectives pinned,
    not GSPMD-inferred) agrees with the single-device path on the 8-device
    virtual CPU mesh;
  - a genuine TWO-PROCESS `jax.distributed` run (the documented
    xla_force_host_platform_device_count-per-process simulation of two
    hosts) where a global-mesh shard_map psum and the sharded segment-sum
    agree with the local computation.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytheiasfm_tpu.ba import BundleAdjustmentOptions, bundle_adjust_dense
from pytheiasfm_tpu.parallel.sharding import make_mesh

sys.path.insert(0, os.path.dirname(__file__))
from test_dense_schur import _make_problem  # noqa: E402


def _run_dense(p, options, mesh=None):
    from pytheiasfm_tpu.models.intrinsics import CameraIntrinsicsModelType as M

    V, T, L = p["V"], p["T"], p["L"]
    return bundle_adjust_dense(
        jnp.asarray(p["ext"]),
        jnp.asarray(p["intr"]),
        jnp.asarray(p["pts"]),
        jnp.asarray(p["view_group"]),
        jnp.asarray(p["group_model_idx"]),
        jnp.asarray(p["track_views"]),
        jnp.asarray(p["uv"].reshape(T, L, 2)),
        jnp.asarray(p["info"].reshape(T, L, 2)),
        jnp.asarray(p["mask"].reshape(T, L)),
        jnp.asarray(p["cam_free"]),
        jnp.asarray(p["pt_free"]),
        present_models=(int(M.PINHOLE),),
        num_views=V,
        num_tracks=T,
        max_track_len=L,
        num_groups=1,
        options=options,
        mesh=mesh,
    )


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
def test_dense_schur_explicit_collectives_matches_single(rng):
    p = _make_problem(rng, T=64)  # divisible by the 8-device mesh
    options = BundleAdjustmentOptions(max_num_iterations=15)
    e1, _, p1, s1 = _run_dense(p, options)
    e2, _, p2, s2 = _run_dense(p, options, mesh=make_mesh(8))
    np.testing.assert_allclose(np.asarray(e2), np.asarray(e1), atol=1e-8)
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p1), atol=1e-8)
    np.testing.assert_allclose(
        float(s2.final_cost), float(s1.final_cost), rtol=1e-10
    )


_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
sys.path.insert(0, "{repo}")
# Config updates (not env vars) pin the platform, so the worker runs on
# the CPU even where an accelerator plug-in was imported first.
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_enable_x64", True)  # f64: 1e-8-level agreement below
from pytheiasfm_tpu.parallel import multihost
multihost.initialize(coordinator="localhost:" + port, num_processes=2,
                     process_id=pid)
import jax.numpy as jnp
import numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
from jax import shard_map

idx, nproc, local_n, global_n = multihost.process_info()
assert nproc == 2 and global_n == 4, (nproc, global_n)
mesh = multihost.global_mesh()

# Global psum across the 2-host mesh.
@partial(shard_map, mesh=mesh, in_specs=P("data"), out_specs=P())
def total(x):
    return jax.lax.psum(jnp.sum(x), "data")

import jax.numpy as jnp
xs = jnp.arange(16.0)
from jax.sharding import NamedSharding
g = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("data")), np.arange(16.0)[idx * 8:(idx + 1) * 8],
    (16,),
)
out = total(g)
np.testing.assert_allclose(np.asarray(out), np.arange(16.0).sum())

# Sharded segment-sum over the global mesh vs local reference.
from pytheiasfm_tpu.parallel.distributed import sharded_segment_sum
vals = np.arange(32.0).reshape(32, 1)
ids = (np.arange(32) % 5).astype(np.int32)
gv = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("data")), vals[idx * 16:(idx + 1) * 16], (32, 1))
gi = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("data")), ids[idx * 16:(idx + 1) * 16], (32,))
out = sharded_segment_sum(gv, gi, 5, mesh)
ref = np.zeros((5, 1))
np.add.at(ref, ids, vals)
np.testing.assert_allclose(np.asarray(out), ref)

# 2-D hosts x chips mesh: psum over BOTH axes = global sum.
mesh2 = multihost.global_mesh_2d()
assert dict(mesh2.shape) == {"host": 2, "chip": 2}, mesh2.shape

@partial(shard_map, mesh=mesh2, in_specs=P(("host", "chip")), out_specs=P())
def total2(x):
    return jax.lax.psum(jnp.sum(x), ("host", "chip"))

g2 = jax.make_array_from_process_local_data(
    NamedSharding(mesh2, P(("host", "chip"))),
    np.arange(16.0)[idx * 8:(idx + 1) * 8], (16,),
)
np.testing.assert_allclose(np.asarray(total2(g2)), np.arange(16.0).sum())

# A REAL BA step across the two processes: the dense-Schur kernel with
# its explicit shard_map+psum Schur product on the global mesh, against
# the single-process (mesh=None) solve of the identical problem.
import sys as _sys
_sys.path.insert(0, "{repo}/tests")
os.environ.setdefault("XLA_FLAGS", "")
import numpy as _np
rng = _np.random.default_rng(7)
from test_dense_schur import _make_problem
from pytheiasfm_tpu.ba import BundleAdjustmentOptions, bundle_adjust_dense
from pytheiasfm_tpu.models.intrinsics import CameraIntrinsicsModelType as M
p = _make_problem(rng, T=64, dtype=np.float64)  # T divides the 4-device mesh
V, T, L = p["V"], p["T"], p["L"]
options = BundleAdjustmentOptions(max_num_iterations=8)
def run(mesh_arg):
    return bundle_adjust_dense(
        jnp.asarray(p["ext"]), jnp.asarray(p["intr"]), jnp.asarray(p["pts"]),
        jnp.asarray(p["view_group"]), jnp.asarray(p["group_model_idx"]),
        jnp.asarray(p["track_views"]),
        jnp.asarray(p["uv"].reshape(T, L, 2)),
        jnp.asarray(p["info"].reshape(T, L, 2)),
        jnp.asarray(p["mask"].reshape(T, L)),
        jnp.asarray(p["cam_free"]), jnp.asarray(p["pt_free"]),
        present_models=(int(M.PINHOLE),), num_views=V, num_tracks=T,
        max_track_len=L, num_groups=1, options=options, mesh=mesh_arg,
    )
e_m, _, p_m, s_m = run(mesh)
e_s, _, p_s, s_s = run(None)
np.testing.assert_allclose(np.asarray(e_m), np.asarray(e_s), atol=1e-8)
np.testing.assert_allclose(
    float(s_m.final_cost), float(s_s.final_cost), rtol=1e-8, atol=1e-18
)
print("OK process", idx)
"""


def test_two_process_distributed(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("{repo}", repo))
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), port],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert "OK process 0" in outs[0]
    assert "OK process 1" in outs[1]
