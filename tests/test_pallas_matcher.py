"""Fused Triton-route matcher vs the XLA reference path. On the CPU the
kernel runs in Pallas interpret mode; on the GPU it is compiled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytheiasfm_tpu.matching import brute_force
from pytheiasfm_tpu.matching import pallas_matcher
from pytheiasfm_tpu.matching.brute_force import (
    choose_matcher,
    match_descriptors_batch,
    match_descriptors_batch_auto,
)
from pytheiasfm_tpu.matching.pallas_matcher import (
    match_descriptors_batch_pallas,
    merge_column_partials,
)
from pytheiasfm_tpu.utils import counters


@pytest.fixture
def interpret():
    return jax.default_backend() == "cpu"


def _descs(rng, P, N, D, noise=0.05):
    base = rng.normal(size=(P, N, D)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    d2 = base + rng.normal(size=base.shape).astype(np.float32) * noise
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(N) for _ in range(P)])
    d2_shuf = np.take_along_axis(d2, perm[:, :, None], axis=1)
    return base, d2_shuf, perm


@pytest.mark.parametrize(
    "N,D,tiles", [(256, 128, (128, 128)), (512, 64, (64, 128)), (128, 40, (32, 64))]
)
def test_pallas_matches_xla(rng, interpret, N, D, tiles):
    P = 2
    d1, d2, perm = _descs(rng, P, N, D)
    m1 = np.ones((P, N), bool)
    m2 = np.ones((P, N), bool)
    m1[:, -7:] = False  # exercise masking
    m2[:, -3:] = False
    ratio = jnp.asarray(0.8, jnp.float32)

    idx_ref, dist_ref = match_descriptors_batch(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        ratio,
    )
    idx_pl, dist_pl = match_descriptors_batch_pallas(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        ratio, tile_i=tiles[0], tile_j=tiles[1], interpret=interpret,
    )
    idx_ref = np.asarray(idx_ref)
    idx_pl = np.asarray(idx_pl)
    # bf16 rounding can flip near-ties; demand near-exact agreement.
    agree = (idx_ref == idx_pl).mean()
    assert agree > 0.99, f"agreement {agree}"
    # And the matches that agree must be the ground-truth permutation.
    ok = idx_pl >= 0
    for p in range(P):
        rows = np.flatnonzero(ok[p])
        inv = np.empty(N, np.int64)
        inv[perm[p]] = np.arange(N)
        correct = (idx_pl[p][rows] == inv[rows]).mean()
        assert correct > 0.95
    # Distances agree where defined.
    sel = (idx_ref == idx_pl) & (idx_ref >= 0)
    np.testing.assert_allclose(
        np.asarray(dist_pl)[sel], np.asarray(dist_ref)[sel], rtol=1e-3,
        atol=1e-4,
    )


def test_pallas_no_ratio_no_symmetric(rng, interpret):
    P, N, D = 1, 256, 128
    d1, d2, _ = _descs(rng, P, N, D)
    m = jnp.ones((P, N), bool)
    ratio = jnp.asarray(0.8, jnp.float32)
    idx_ref, _ = match_descriptors_batch(
        jnp.asarray(d1), jnp.asarray(d2), m, m, ratio,
        use_lowes_ratio=False, keep_only_symmetric=False,
    )
    idx_pl, _ = match_descriptors_batch_pallas(
        jnp.asarray(d1), jnp.asarray(d2), m, m, ratio,
        use_lowes_ratio=False, keep_only_symmetric=False,
        tile_i=128, tile_j=128, interpret=interpret,
    )
    assert (np.asarray(idx_ref) == np.asarray(idx_pl)).mean() > 0.99


def test_kernel_column_partials_are_exact_top2(rng, interpret):
    """The kernel's per-row-tile column partials, merged, equal a NumPy
    top-2 over the full distance matrix (operands bf16-rounded)."""
    P, N, D, TI = 2, 256, 32, 64
    d1, d2, _ = _descs(rng, P, N, D)
    b1 = jnp.asarray(d1, jnp.bfloat16)
    b2 = jnp.asarray(d2, jnp.bfloat16)
    a1 = jnp.sum(jnp.asarray(d1) ** 2, -1)
    a2 = jnp.sum(jnp.asarray(d2) ** 2, -1)
    fb1, fb2, fa, cb1, cb2, ca = pallas_matcher.streaming_top2(
        b1, b2, a1, a2, tile_i=TI, tile_j=64, interpret=interpret
    )
    assert cb1.shape == (P, N // TI, N)
    r1, r2, ra = (np.asarray(x) for x in merge_column_partials(cb1, cb2, ca))
    x1 = np.asarray(b1.astype(jnp.float32), np.float64)
    x2 = np.asarray(b2.astype(jnp.float32), np.float64)
    dist = np.maximum(
        np.asarray(a1)[:, :, None] + np.asarray(a2)[:, None, :]
        - 2 * np.einsum("pid,pjd->pij", x1, x2),
        0.0,
    )
    srt = np.sort(dist, axis=1)  # over rows, per column
    np.testing.assert_array_equal(ra, np.argmin(dist, axis=1))
    np.testing.assert_allclose(r1, srt[:, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r2, srt[:, 1], rtol=1e-5, atol=1e-5)
    srt_r = np.sort(dist, axis=2)
    np.testing.assert_array_equal(np.asarray(fa), np.argmin(dist, axis=2))
    np.testing.assert_allclose(np.asarray(fb1), srt_r[..., 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(fb2), srt_r[..., 1], rtol=1e-5, atol=1e-5)


def test_merge_column_partials_vs_numpy(rng):
    """Merge of per-tile (best, second, arg) partials equals a NumPy top-2
    over the concatenated tiles, ties included."""
    P, K, TI, N = 3, 4, 8, 16
    vals = rng.integers(0, 6, size=(P, K * TI, N)).astype(np.float32)
    tiles = vals.reshape(P, K, TI, N)
    order = np.argsort(tiles, axis=2, kind="stable")
    cb1 = np.take_along_axis(tiles, order[:, :, :1], 2)[:, :, 0]
    cb2 = np.take_along_axis(tiles, order[:, :, 1:2], 2)[:, :, 0]
    ca = (order[:, :, 0] + np.arange(K)[None, :, None] * TI).astype(np.int32)
    b1, b2, arg = merge_column_partials(
        jnp.asarray(cb1), jnp.asarray(cb2), jnp.asarray(ca)
    )
    srt = np.sort(vals, axis=1)
    np.testing.assert_array_equal(np.asarray(b1), srt[:, 0])
    np.testing.assert_array_equal(np.asarray(b2), srt[:, 1])
    np.testing.assert_array_equal(np.asarray(arg), np.argmin(vals, axis=1))


@pytest.mark.parametrize(
    "backend,N,expected",
    [
        ("cpu", 4096, "xla"),
        ("gpu", 4096, "triton"),
        ("gpu", 128, "triton"),
        ("gpu", 64, "xla"),
        ("gpu", 3000, "xla"),
    ],
)
def test_choose_matcher(backend, N, expected):
    assert choose_matcher(N, backend) == expected


def test_auto_records_choice_on_cpu(rng):
    P, N, D = 1, 128, 16
    d1, d2, _ = _descs(rng, P, N, D)
    m = jnp.ones((P, N), bool)
    counters.reset()
    match_descriptors_batch_auto(
        jnp.asarray(d1), jnp.asarray(d2), m, m, jnp.float32(0.8)
    )
    assert counters.snapshot() == {"matcher_xla": 1}


def test_auto_runs_kernel_on_gpu_and_raises_on_failure(rng, monkeypatch):
    """On "gpu" the auto entry calls the kernel, and a kernel error
    propagates: there is no fallback to the XLA matcher."""
    P, N, D = 1, 128, 16
    d1, d2, _ = _descs(rng, P, N, D)
    m = jnp.ones((P, N), bool)
    monkeypatch.setattr(brute_force.jax, "default_backend", lambda: "gpu")

    calls = []

    def boom(*args, **kwargs):
        calls.append(kwargs)
        raise RuntimeError("kernel failed to compile")

    monkeypatch.setattr(pallas_matcher, "match_descriptors_batch_pallas", boom)
    counters.reset()
    with pytest.raises(RuntimeError, match="kernel failed"):
        match_descriptors_batch_auto(
            jnp.asarray(d1), jnp.asarray(d2), m, m, jnp.float32(0.8)
        )
    assert len(calls) == 1
    assert counters.snapshot() == {"matcher_triton": 1}
