"""RANSAC distributed over a device mesh: sharded feature NN + sharded
hypothesis evaluation at single-chip feature parity.

Two independent axes of the coarse-registration work distribute naturally
over the device interconnect (BASELINE.json configs[4]; the reference is
single-GPU — registration.cpp:204-295 — so this is capability beyond it):

  1. **Feature correspondences** (the O(N·M·33) descriptor argmin,
     registration.cpp:216-232): the TARGET descriptor matrix is row-sharded
     — each device scans its shard with the tiled top-1 search, and the
     global winner is a (n_shards, Q) argmin over an ``all_gather`` of
     per-shard (distance, index) pairs. Bandwidth ∝ queries, not targets.

  2. **Hypotheses** (the 100k-iteration loop, registration.cpp:238-291):
     embarrassingly parallel. The single-chip path's full cost engineering
     carries over (VERDICT r3 item 2 — parity, not just correctness):

     - **Chunked early exit**: a per-shard ``lax.while_loop`` over ROUNDS;
       in round c shard s solves/scores its ``hyp_l`` hypotheses, so one
       round dispatches the same global chunk the single-chip path would
       (``hyp_l = hyp_chunk / n_shards``) and an easy scene pays for ONE
       round instead of the whole budget. The reference's sequential-prefix
       semantics (registration.cpp:284-290) are restored globally each
       round with two scalar collectives: the cutoff is the MIN over
       shards of the first confidence-exceeding global id, and the winner
       is the best fitness among ids ≤ cutoff with earliest-id tie-break
       (exactly the strict-``>`` update order of the sequential loop).
     - **Rotation sampling** (gather-free triples): the shared
       :func:`tpu3d.ops.ransac.solve_rotation_chunk` over the
       :func:`~tpu3d.ops.ransac.build_rotation_table` plane table,
       replicated once. Each (round, shard) slot consumes exactly ``cons``
       iteration ids (``cons`` depends only on the replicated valid count),
       so global ids are ``fid + sid·cons + local cumsum`` and the
       max_iterations budget is delivered exactly. Per-epoch base
       rotations make sub-``n`` shard chunks unbiased (each shard scores
       a random arc of the compacted rows).
     - **Est + exact rescore**: every hypothesis is estimate-scored on the
       strided ``est_cap`` subset; each shard exact-rescores only its
       top-32 finalists, then the round champions are reduced. The cutoff
       and winner PICK run on estimates — the same documented delta as on
       one chip; the returned fitness/rmse come from the direct winner
       rescore (below) and are exact.
     - **Direct winner rescore** (registration.cpp:270-282): one residual
       pass over the single winner outside the mesh region, replicated —
       identical numerics to the single-chip path.

The hypothesis stream is the same counter-based ``jax.random`` scheme,
keyed by (round, shard) — the same reseeding-class delta as any chunking
of the draw stream. tests/test_parallel.py gates pose parity and the
round-count cost profile; the multi-seed gate lives in
tests/test_ransac_sharded_ab.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpu3d.ops.ransac import (
    build_rotation_table,
    build_scoring_factors,
    decimation_stride,
    pack_hypotheses,
    score_w16,
    solve_rotation_chunk,
)
from tpu3d.ops.transforms import kabsch_quat, make_transform
from tpu3d.types import FPFHFeatures, PointCloud, RegistrationResult

_INT_MAX = jnp.int32(2**31 - 1)


def feature_correspondences_sharded(
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    mesh: Mesh,
    axis: str = "shard",
) -> jnp.ndarray:
    """Nearest 33-D target descriptor per source row, targets row-sharded.

    Same semantics as ops.ransac.feature_correspondences (ties → lowest
    global index whenever the minimum is unique; exact-tie order is
    lowest-shard-first). Returns GLOBAL target rows, i32[Q]."""
    from tpu3d.ops.nn_pallas import nearest_neighbor

    n_shards = mesh.shape[axis]
    m = target_features.descriptors.shape[0]
    if m % n_shards:
        raise ValueError(f"target rows {m} % {n_shards} shards != 0")
    shard_rows = m // n_shards

    def local(qd, td, tm):
        idx, d2 = nearest_neighbor(qd, td, tm)
        offset = jax.lax.axis_index(axis) * shard_rows
        gath_d = jax.lax.all_gather(d2, axis)  # (n_shards, Q)
        gath_i = jax.lax.all_gather(idx + offset, axis)
        win = jnp.argmin(gath_d, axis=0)
        return gath_i[win, jnp.arange(d2.shape[0])]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,  # replicated by construction
    )
    return fn(
        source_features.descriptors,
        target_features.descriptors,
        target_features.mask,
    )


@functools.partial(
    jax.jit,
    static_argnames=("max_iterations", "mesh", "axis", "corr_cap",
                     "corr_mode", "hyp_chunk", "est_cap", "sampling",
                     "return_consumed"),
)
def ransac_registration_sharded(
    source: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    voxel_size,
    mesh: Mesh,
    axis: str = "shard",
    max_iterations: int = 100000,
    confidence: float = 0.999,
    seed: int = 42,
    corr_cap: int = 8192,
    corr_mode: str = "auto",
    hyp_chunk: int | str = "auto",
    est_cap: int = 2048,
    sampling: str = "auto",
    return_consumed: bool = False,
):
    """Distributed analog of ops.ransac.ransac_registration at feature
    parity (see the module docstring for the per-round collective design).

    ``hyp_chunk`` is the GLOBAL per-round budget (the single-chip chunk);
    each shard dispatches ``hyp_chunk / n_shards`` hypotheses per round, so
    total dispatched work matches the single-chip chunked path round for
    round. ``return_consumed`` additionally returns the number of
    iteration ids actually consumed (the cost-profile diagnostic the
    round-count test gates on)."""
    voxel_size = jnp.asarray(voxel_size, jnp.float32)
    thr2 = (voxel_size * 1.5) ** 2
    n_shards = mesh.shape[axis]
    if hyp_chunk == "auto":
        # Same 4-round auto target as the single-chip path (its
        # hyp_chunk='auto' rationale, ops/ransac.py).
        quarter = -(-max_iterations // 4)
        hyp_chunk = max(16384, (quarter + 1023) // 1024 * 1024)
    hyp_l = -(-hyp_chunk // n_shards)  # per-shard slice of a round

    src_pts = source.points
    src_mask = source.mask
    src_desc = source_features.descriptors
    n = src_pts.shape[0]
    if corr_mode in ("subsample", "auto") and n >= 2 * corr_cap:
        stride = decimation_stride(n, corr_cap)
        take = stride * corr_cap
        src_pts = src_pts[:take].reshape(corr_cap, stride, 3)[:, 0, :]
        src_mask = src_mask[:take].reshape(corr_cap, stride)[:, 0]
        src_desc = src_desc[:take].reshape(
            corr_cap, stride, src_desc.shape[1]
        )[:, 0, :]
        n = corr_cap

    corr = feature_correspondences_sharded(
        FPFHFeatures(descriptors=src_desc, mask=src_mask),
        target_features, mesh, axis,
    )
    p = src_pts.astype(jnp.float32)
    q = target.points[corr].astype(jnp.float32)
    n_valid = jnp.maximum(jnp.sum(src_mask.astype(jnp.float32)), 1.0)
    feat_t, pq_norm = build_scoring_factors(p, q, src_mask)
    perm = jnp.argsort(~src_mask, stable=True)  # valid rows first
    count = jnp.maximum(jnp.sum(src_mask.astype(jnp.int32)), 1)
    pq_packed = jnp.concatenate([p, q], axis=1)
    key = jax.random.PRNGKey(seed)
    hyp_key = jax.random.fold_in(key, 7)
    max_it = jnp.int32(max_iterations)

    # Rotation sampling: shard slices may be shorter than n (the per-epoch
    # base rotation keeps sub-n truncation unbiased — see module
    # docstring); n >= 2048 bounds the per-shard epoch unroll like the
    # single-chip gate.
    if sampling == "auto":
        use_rotation = n >= 2048
    else:
        use_rotation = sampling == "rotation"
    pq2p = (
        build_rotation_table(pq_packed, src_mask, count) if use_rotation
        else None
    )
    # Per-shard consumed ids per round (replicated — depends only on
    # count): full epochs contribute `count` each, the tail min(rem, count).
    cons = (
        (hyp_l // n) * count + jnp.minimum(hyp_l % n, count)
        if use_rotation else jnp.int32(hyp_l)
    )

    use_est = n >= 2 * est_cap
    if use_est:
        st_e = decimation_stride(n, est_cap)
        tke = st_e * est_cap
        p_e = p[:tke].reshape(est_cap, st_e, 3)[:, 0]
        q_e = q[:tke].reshape(est_cap, st_e, 3)[:, 0]
        m_e = src_mask[:tke].reshape(est_cap, st_e)[:, 0]
        feat_e, pq_e = build_scoring_factors(p_e, q_e, m_e)
        n_valid_e = jnp.maximum(jnp.sum(m_e.astype(jnp.float32)), 1.0)
        k_fin = min(32, hyp_l)

    id_w16 = jnp.concatenate(
        [
            jnp.zeros((6,), jnp.float32),
            jnp.eye(3, dtype=jnp.float32).reshape(9),
            jnp.zeros((1,), jnp.float32),
        ]
    )

    def local(feat_l, pq_l, feat_el, pq_el, pq2p_l, perm_l, count_l,
              cons_l, nv_l, nve_l):
        sid = jax.lax.axis_index(axis)

        def body(state):
            c, fid, _, bf, bw = state
            kc = jax.random.fold_in(hyp_key, c * n_shards + sid)
            first_id = fid + sid * cons_l
            if use_rotation:
                w16t, t_norm, disabled, ids, _ = solve_rotation_chunk(
                    kc, hyp_l, first_id, pq2p_l, count_l, max_it
                )
            else:
                draws = jax.random.randint(kc, (hyp_l, 3), 0, count_l)
                dup = (
                    (draws[:, 0] == draws[:, 1])
                    | (draws[:, 1] == draws[:, 2])
                    | (draws[:, 0] == draws[:, 2])
                )
                ids = first_id + jnp.arange(hyp_l)
                disabled = dup | (ids >= max_it)
                s6 = pq_packed[perm_l[draws]]  # (h, 3, 6) p‖q rows
                Rs, ts = kabsch_quat(s6[..., :3], s6[..., 3:])
                w16t, t_norm = pack_hypotheses(Rs, ts)
            if use_est:
                cnt_e, _ = score_w16(feat_el, pq_el, w16t, t_norm, thr2)
                fitness = jnp.where(disabled, -1.0, cnt_e / nve_l)
            else:
                cnt, _ = score_w16(feat_l, pq_l, w16t, t_norm, thr2)
                fitness = jnp.where(disabled, -1.0, cnt / nv_l)
            # Global prefix cutoff (registration.cpp:284-290): the first
            # exceeding global id on ANY shard bounds every shard's
            # eligible set this round (collective #1).
            exceed = fitness > confidence
            loc_first = jnp.where(
                jnp.any(exceed), ids[jnp.argmax(exceed)], _INT_MAX
            )
            cutoff = jnp.min(jax.lax.all_gather(loc_first, axis))
            mf = jnp.where(ids <= cutoff, fitness, -2.0)
            if use_est:
                # Per-shard exact rescore of the estimate top-k (ties
                # resolve in estimate-rank order — same statistical-delta
                # class as on one chip).
                _, topk = jax.lax.top_k(mf, k_fin)
                cnt_x, _ = score_w16(
                    feat_l, pq_l, w16t[:, topk], t_norm[topk], thr2
                )
                fit_x = jnp.where(
                    mf[topk] <= -1.0, mf[topk], cnt_x / nv_l
                )
                bi = jnp.argmax(fit_x)
                lb = topk[bi]
                lf = fit_x[bi]
            else:
                lb = jnp.argmax(mf)
                lf = mf[lb]
            # Round champion across shards, earliest-id tie-break — the
            # sequential loop's strict-> update order (collective #2).
            champs_f = jax.lax.all_gather(lf, axis)  # (n_shards,)
            champs_id = jax.lax.all_gather(ids[lb], axis)
            win_shard = jnp.lexsort((champs_id, -champs_f))[0]
            is_w = (sid == win_shard).astype(jnp.float32)
            gw = jax.lax.psum(w16t[:, lb] * is_w, axis)
            gf = champs_f[win_shard]
            done = cutoff < _INT_MAX
            better = gf > bf  # strict: the earliest round keeps ties
            return (
                c + 1,
                fid + n_shards * cons_l,
                done,
                jnp.where(better, gf, bf),
                jnp.where(better, gw, bw),
            )

        def cond(state):
            c, fid, done = state[0], state[1], state[2]
            keep = (fid < max_it) & jnp.logical_not(done)
            if use_rotation:
                # count < 3: no 3-point sample exists — exit with the
                # fitness-0 identity (the reference's equivalent: every
                # draw is a duplicate-rejected no-op).
                keep = keep & (count_l >= 3)
            return keep

        _, fid, _, bf, bw = jax.lax.while_loop(
            cond,
            body,
            (jnp.int32(0), jnp.int32(0), jnp.bool_(False),
             jnp.float32(0.0), id_w16),
        )
        return bf, bw, jnp.minimum(fid, max_it)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(),) * 10,
        out_specs=(P(), P(), P()),
        check_vma=False,  # psum/all_gather results are replicated
    )
    zero2 = jnp.zeros((2, 2), jnp.float32)  # placeholder when unused
    best_fitness, bw, consumed = fn(
        feat_t, pq_norm,
        feat_e if use_est else zero2,
        pq_e if use_est else zero2[0],
        pq2p if use_rotation else zero2,
        perm, count, cons, n_valid,
        n_valid_e if use_est else jnp.float32(1.0),
    )
    best_R = bw[6:15].reshape(3, 3)
    best_t = bw[3:6]

    # Direct winner rescore (registration.cpp:270-282) — replicated, same
    # numerics as the single-chip path (see ops/ransac.py for the f32
    # cancellation-floor rationale and the `won` demotion rule).
    dr = p @ best_R.T + best_t - q
    err2_d = jnp.sum(dr * dr, axis=1)
    inl_d = src_mask & (err2_d < thr2)
    cnt_d = jnp.sum(inl_d.astype(jnp.float32))
    won = (best_fitness > 0.0) & (cnt_d > 0)
    fit_d = cnt_d / n_valid
    rmse_d = jnp.where(
        cnt_d > 0,
        jnp.sqrt(
            jnp.sum(jnp.where(inl_d, err2_d, 0.0))
            / jnp.maximum(cnt_d, 1.0)
        ),
        999.0,
    )
    T = make_transform(best_R, best_t)
    res = RegistrationResult(
        transformation=jnp.where(won, T, jnp.eye(4, dtype=jnp.float32)),
        fitness=jnp.where(won, fit_d, 0.0),
        rmse=jnp.where(won, rmse_d, 0.0),
    )
    if return_consumed:
        return res, consumed
    return res
