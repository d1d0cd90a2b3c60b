"""slab2_top1 (Triton kernel, interpret mode) vs brute force: exact same winners.

Ties: slab2_top1 resolves to the lowest SORTED target row, which may be
a different ORIGINAL row than brute-force's lowest-original-row at
exactly-equal distances — compare by distance (exact f32 arithmetic on
both sides), the same contract the rest of the codebase uses.
"""

import jax.numpy as jnp
import numpy as np

from tpu3d.ops.nn_walk import slab2_top1


def _brute(q, qm, t, tm, r):
    d2 = ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    d2 = np.where(tm[None, :], d2, 1e30)
    idx = np.argmin(d2, axis=1)
    best = d2[np.arange(len(q)), idx]
    best = np.where(qm & (best <= r * r), best, 1e30)
    return idx, best


def test_slab2_top1_matches_brute(rng):
    nq, nt = 700, 900
    q = rng.uniform(-0.3, 0.3, (nq, 3)).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, (nt, 3)).astype(np.float32)
    qm = np.ones(nq, bool)
    qm[::17] = False
    tm = np.ones(nt, bool)
    tm[::13] = False
    r = 0.05
    idx, d2 = slab2_top1(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t), jnp.asarray(tm),
        jnp.float32(r), block=128, sub=128, engine="triton", interpret=True,
    )
    bidx, bd2 = _brute(q, qm, t, tm, r)
    d2 = np.asarray(d2)
    idx = np.asarray(idx)
    matched = bd2 < 1e29
    assert np.array_equal(d2 < 1e29, matched)
    np.testing.assert_allclose(d2[matched], bd2[matched], rtol=1e-6)
    # The selected target must realize the reported distance.
    realized = ((q[matched] - t[idx[matched]]) ** 2).sum(-1)
    np.testing.assert_allclose(realized, bd2[matched], rtol=1e-6)


def test_slab2_top1_no_matches(rng):
    q = rng.uniform(10.0, 11.0, (200, 3)).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    idx, d2 = slab2_top1(
        jnp.asarray(q), jnp.ones(200, bool), jnp.asarray(t),
        jnp.ones(300, bool), jnp.float32(0.05), block=128, sub=128,
        engine="triton", interpret=True,
    )
    assert np.all(np.asarray(d2) >= 1e29)


def test_slab2_top1_degenerate_x(rng):
    """All targets in one slab column — windows stay exact."""
    nq = nt = 400
    t = np.zeros((nt, 3), np.float32)
    t[:, 1:] = rng.uniform(-0.2, 0.2, (nt, 2)).astype(np.float32)
    q = t + rng.normal(0, 0.004, (nq, 3)).astype(np.float32)
    r = 0.03
    idx, d2 = slab2_top1(
        jnp.asarray(q), jnp.ones(nq, bool), jnp.asarray(t),
        jnp.ones(nt, bool), jnp.float32(r), block=128, sub=128,
        engine="triton", interpret=True,
    )
    bidx, bd2 = _brute(q, np.ones(nq, bool), t, np.ones(nt, bool), r)
    matched = bd2 < 1e29
    np.testing.assert_allclose(
        np.asarray(d2)[matched], bd2[matched], rtol=1e-6
    )
