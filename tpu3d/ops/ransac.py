"""RANSAC coarse registration as one batch of parallel hypotheses.

Reference semantics (src/registration.cpp:204-295):
  - one-time nearest-neighbor correspondences in 33-D FPFH space
    (brute force, registration.cpp:216-232) — here the tiled top-1
    search of ops/nn_pallas.py (matmul + running argmin);
  - per hypothesis: 3 random source indices (duplicates rejected,
    registration.cpp:239-240), Kabsch with reflection fix (:254-262) — here
    the closed-form QCP quaternion solve, no batched SVD;
  - inliers at ``err < 1.5 * voxel_size`` (:213, :275), fitness =
    inliers/N, rmse over inliers (999 if none), keep best fitness
    (strict >, so earliest of equals), stop once fitness > confidence
    (:284-290);
  - fixed seed: std::mt19937(42) (:235) — here a counter-based
    ``jax.random`` key (default seed 42). Bit-identical sampling with
    mt19937 is impossible and not a goal; fidelity is gated on inlier sets
    and pose error (BASELINE.md).

Device formulation: ALL hypotheses are generated, solved and scored at once.
Scoring expands ||R·p + t − q||² into a rank-15 product

  err²[n,h] = F_n · W_h + (||p_n||² + ||q_n||²) + ||t_h||²
  F_n = [2p, −2q, −2(q⊗p)]   (n,15)     W_h = [Rᵀt, t, vec(R)]   (h,15)

executed by a fused Triton kernel on the GPU (ops/ransac_pallas.py — the
err² tile never leaves registers) or a chunked lax.map on the CPU. The reference's
sequential early-exit is emulated exactly at the semantic level: the
returned result is the best hypothesis in the prefix ending at the first
one whose fitness exceeds ``confidence`` (the break at
registration.cpp:290).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu3d.ops.nn_pallas import nearest_neighbor
from tpu3d.ops.ransac_pallas import score_hypotheses_triton
from tpu3d.ops.transforms import kabsch3_planes, kabsch_quat, make_transform
from tpu3d.types import FPFHFeatures, PointCloud, RegistrationResult
from tpu3d.utils.platform import resolve_engine


def decimation_stride(n: int, cap: int) -> int:
    """Stride for gather-free strided decimation of ``n`` rows down to
    ``cap``, nudged AWAY from common raster-width factors (2 and 5): a
    stride sharing a large factor with the sensor scan-line width
    collapses the subset onto a few image columns (stride 80 on a
    640-wide raster hits only gcd-many = 8 columns). Both adjustments
    only shrink the stride, so cap*stride never exceeds n. Requires
    n >= 2*cap (callers gate)."""
    stride = n // cap
    if stride > 2 and stride % 2 == 0:
        stride -= 1
    if stride > 5 and stride % 5 == 0:
        stride -= 2
    return stride


def build_scoring_factors(p_, q_, mask_):
    """Point-side rank-16 scoring factors for err²[n,h] = F_n·W_h + pq_n +
    ‖t_h‖² (see module docstring). K-major (16, N) layout: the 9
    outer-product rows are plain (N,) elementwise products (no (N,3,3)
    broadcast and (N,9) relayout). Invalid rows get pq = 1e30 so they can never score
    as inliers. Shared by the single-chip path and the hypothesis-sharded
    path (tpu3d/parallel/ransac_sharded.py)."""
    px, py, pz = p_[:, 0], p_[:, 1], p_[:, 2]
    qx, qy, qz = q_[:, 0], q_[:, 1], q_[:, 2]
    pq = px * px + py * py + pz * pz + qx * qx + qy * qy + qz * qz
    pq = jnp.where(mask_, pq, 1e30)  # invalid rows never hit
    ft = jnp.stack(
        [
            2.0 * px, 2.0 * py, 2.0 * pz,
            -2.0 * qx, -2.0 * qy, -2.0 * qz,
            -2.0 * qx * px, -2.0 * qx * py, -2.0 * qx * pz,
            -2.0 * qy * px, -2.0 * qy * py, -2.0 * qy * pz,
            -2.0 * qz * px, -2.0 * qz * py, -2.0 * qz * pz,
            jnp.zeros(p_.shape[:1], jnp.float32),  # pad 15 → 16
        ]
    )  # (16, N) — rows 6-14 pair with vec(R) row-major in w16t
    return ft, pq


def pack_hypotheses(Rs, ts):
    """(h,3,3)/(h,3) QCP solutions → K-major (16, h) scoring factors
    [Rᵀt | t | vec(R) | 0] plus ‖t‖² — the hypothesis side of the rank-16
    expansion. Built as 16 stacked (h,) vectors (no (h,16)
    concat-then-transpose relayout)."""
    u = jnp.einsum("hij,hi->hj", Rs, ts)  # Rᵀ t
    h = ts.shape[0]
    w16t = jnp.stack(
        [u[:, 0], u[:, 1], u[:, 2], ts[:, 0], ts[:, 1], ts[:, 2]]
        + [Rs[:, i, j] for i in range(3) for j in range(3)]
        + [jnp.zeros((h,), jnp.float32)]
    )  # (16, h)
    return w16t, jnp.sum(ts * ts, axis=1)


def score_w16(feat_s, pq_s, w_s, tn_s, thr2, chunk=512, engine="auto",
              interpret=False):
    """Exact inlier count + squared-error sum per hypothesis: the fused
    Triton kernel (ops/ransac_pallas.py) or a chunked lax.map, as the
    engine table says. feat_s (16, N) and w_s (16, H) are K-major."""
    if resolve_engine(engine, "score", interpret) == "triton":
        return score_hypotheses_triton(
            feat_s, pq_s, w_s, tn_s, thr2, interpret=interpret
        )

    def score_chunk(args):
        wc, tc = args  # (16, C), (C,)
        err2 = (
            jax.lax.dot_general(
                feat_s, wc, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            + pq_s[:, None]
            + tc[None, :]
        )
        inl = err2 < thr2
        return (
            jnp.sum(inl.astype(jnp.float32), axis=0),
            jnp.sum(jnp.where(inl, jnp.maximum(err2, 0.0), 0.0), axis=0),
        )

    hh = w_s.shape[1]
    cc = min(chunk, hh)
    pad_h = (-hh) % cc  # padded hypotheses score harmlessly (id transform)
    if pad_h:
        w_s = jnp.pad(w_s, ((0, 0), (0, pad_h)))
        tn_s = jnp.pad(tn_s, (0, pad_h))
    n_chunks = (hh + pad_h) // cc
    c_, e_ = jax.lax.map(
        score_chunk,
        (
            jnp.moveaxis(w_s.reshape(16, n_chunks, cc), 1, 0),
            tn_s.reshape(n_chunks, cc),
        ),
    )
    return c_.reshape(-1)[:hh], e_.reshape(-1)[:hh]


def build_rotation_table(pq_packed, src_mask, count):
    """Mod-count roll table for the rotation sampler, PLANE-major (6, 2n):
    columns [0, count) hold the compacted valid rows' p‖q planes, and a
    second full copy starts AT column ``count`` (one dynamic_update_slice),
    so for any shift r < count the contiguous window pq2p[:, r : r + n]
    reads row (i + r) mod count at position i for every i < count
    (positions i >= count are junk either way — slot validity masks them).
    The valid-first compaction rides the sort network (stable multi-operand
    ``lax.sort`` keyed on ~mask — identical order to the stable argsort it
    replaces, without a ``pq_packed[perm]`` row gather). Each epoch slot
    is then a single dynamic_slice already in the layout the plane solve
    consumes. Shared by the single-chip chunked path and the
    hypothesis-sharded path (tpu3d/parallel/ransac_sharded.py)."""
    key = (~src_mask).astype(jnp.int32)  # valid rows first, stable
    sorted_cols = jax.lax.sort(
        (key,) + tuple(pq_packed[:, j] for j in range(6)), num_keys=1
    )[1:]
    pq_sorted_t = jnp.stack(sorted_cols)  # (6, n)
    return jax.lax.dynamic_update_slice(
        jnp.concatenate(
            [pq_sorted_t, jnp.zeros_like(pq_sorted_t)], axis=1
        ),
        pq_sorted_t,
        (jnp.int32(0), count),
    )


def solve_rotation_chunk(kc, h, first_id, pq2p, count, max_iterations):
    """Gather-free 3-point sampling (see ``sampling`` in
    ransac_registration's docstring): E = ceil(h/n) epochs over the
    compacted valid-first table; epoch e yields triples
    (i, (i+r1)%count, (i+r2)%count) for every valid row i. Each mod-count
    roll is ONE contiguous dynamic_slice of the doubled (6, 2n)
    plane-major table ``pq2p`` (build_rotation_table — no per-row gather).
    Returns (w16t, t_norm, disabled, ids, n_consumed): ids are first_id +
    the cumsum of valid slot-1 rows, so each valid triple consumes exactly
    one iteration of the max_iterations budget (the sharded path needs the
    ids themselves for its GLOBAL prefix cutoff —
    tpu3d/parallel/ransac_sharded.py)."""
    n = pq2p.shape[1] // 2
    n_ep = -(-h // n)
    cm1 = jnp.maximum(count - 1, 1)
    cm2 = jnp.maximum(count - 2, 1)
    iota = jnp.arange(n)
    valid1 = iota < count
    slots1, slots2, slots3 = [], [], []
    for e in range(n_ep):
        u = jax.random.randint(
            jax.random.fold_in(kc, e), (3,), 0, 1 << 30
        )
        a = u[0] % cm1
        r1 = 1 + a
        r2 = 1 + (a + 1 + u[1] % cm2) % cm1
        # Per-epoch base rotation r0: epoch h-truncation would
        # otherwise overweight a fixed row prefix every chunk.
        r0 = u[2] % jnp.maximum(count, 1)

        def roll_mod(r):
            # column i -> column (i + r) mod count (i < count; junk
            # above): one contiguous dynamic_slice of the doubled
            # PLANE table (pq2p[:, i + r] = plane value of sorted row
            # (i + r) mod count for every i < count when r < count —
            # see build_rotation_table). Plane-major so the epoch
            # concat below lands directly in the (6, h) layout the
            # QCP plane solve consumes — the former (h, 6) slot
            # tables needed three (h, 6)→(6, h) relayouts per chunk.
            return jax.lax.dynamic_slice(pq2p, (0, r), (6, n))

        slots1.append(roll_mod(r0))
        slots2.append(roll_mod(jax.lax.rem(r0 + r1, count)))
        slots3.append(roll_mod(jax.lax.rem(r0 + r2, count)))
    s1t = jnp.concatenate(slots1, axis=1)[:, :h]
    s2t = jnp.concatenate(slots2, axis=1)[:, :h]
    s3t = jnp.concatenate(slots3, axis=1)[:, :h]
    vv = jnp.concatenate([valid1] * n_ep, axis=0)[:h]
    ids = first_id + jnp.cumsum(vv.astype(jnp.int32)) - 1
    # count < 3: a 3-point sample cannot exist (the reference would
    # reject every draw as duplicate) — disable all, yielding the
    # fitness-0 identity result.
    disabled = (~vv) | (ids >= max_iterations) | (count < 3)
    # Plane-based QCP solve on the (6, h) slot planes: the whole
    # ~100-op solve chain runs on (h,) planes at full lane occupancy.
    # The (h, 3, 6)-stacked kabsch_quat alternative runs its
    # centering/correlation micro-ops on minor-dim-3/6 arrays (≤6 of
    # 128 lanes live). NOTE the 18-gather kabsch3_planes variant in
    # solve_hypotheses' docstring was reverted for its GATHER cost —
    # this path has no gathers at all (slots are contiguous rolls).
    ps = tuple((st[0], st[1], st[2]) for st in (s1t, s2t, s3t))
    qs = tuple((st[3], st[4], st[5]) for st in (s1t, s2t, s3t))
    r_pl, t_pl = kabsch3_planes(ps, qs)
    # Pack the scoring factors straight from planes: [Rᵀt | t |
    # vec(R) | 0] (same rows as pack_hypotheses, no (h,3,3) slicing).
    u = tuple(
        r_pl[j] * t_pl[0] + r_pl[3 + j] * t_pl[1]
        + r_pl[6 + j] * t_pl[2]
        for j in range(3)
    )
    w16t = jnp.stack(
        list(u) + list(t_pl) + list(r_pl)
        + [jnp.zeros_like(t_pl[0])]
    )  # (16, h)
    t_norm = (
        t_pl[0] * t_pl[0] + t_pl[1] * t_pl[1] + t_pl[2] * t_pl[2]
    )
    n_consumed = jnp.sum(vv.astype(jnp.int32))
    return w16t, t_norm, disabled, ids, n_consumed


def feature_correspondences(
    source_features: FPFHFeatures, target_features: FPFHFeatures
) -> jnp.ndarray:
    """Nearest target index in 33-D descriptor space per source point
    (registration.cpp:216-232). Ties → lowest index, like the reference.
    IEEE f32 distances on every engine (ops/nn_pallas.py)."""
    idx, _ = nearest_neighbor(
        source_features.descriptors,
        target_features.descriptors,
        target_features.mask,
    )
    return idx


@functools.partial(
    jax.jit,
    static_argnames=("max_iterations", "chunk", "two_stage", "corr_cap",
                     "corr_mode", "hyp_chunk", "early_exit", "est_cap",
                     "sampling"),
)
def ransac_registration(
    source: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    voxel_size,
    max_iterations: int = 100000,
    confidence: float = 0.999,
    seed: int = 42,
    chunk: int = 512,
    two_stage: str | bool = "auto",
    corr_cap: int = 8192,
    corr_mode: str = "auto",
    hyp_chunk: int | str = "auto",
    early_exit: str | bool = "auto",
    est_cap: int = 2048,
    sampling: str = "auto",
) -> RegistrationResult:
    """``two_stage``: score every hypothesis on a 16k-point subsample first,
    then re-score only the top 1024 on all points (exact fitness/rmse for
    the winner). Statistically safe — the subsample fitness estimate has
    σ ≈ 0.4%, and 1024 finalists is a huge margin over that — but the
    early-exit-prefix cutoff is evaluated on stage-1 estimates, a documented
    delta vs the reference's exact sequential ordering. 'auto' enables it
    when the cloud is ≥ 2x the subsample and there are > 4096 hypotheses.

    ``corr_mode``/``corr_cap``: at scale the O(N·M·33) descriptor NN is the
    cost center, but RANSAC only consumes correspondences statistically —
    3-point samples and inlier fractions. 'auto' (or 'subsample') computes
    EXACT correspondences for a random ``corr_cap``-row subset of the
    source when the cloud is ≥ 2x that size (each correspondence is still
    the exact 33-D NN; there are just fewer of them). Hypotheses are drawn
    from and scored on the subset: pose quality is statistically unchanged
    and fitness/rmse become unbiased estimates with σ ≈ 0.55% at the 8k
    default (0.4% at 16k) — the same class of delta as ``two_stage``. 'exact' always matches every
    source row (the reference's semantics, registration.cpp:216-232).

    ``early_exit``/``hyp_chunk``: the reference evaluates hypotheses
    SEQUENTIALLY and breaks at the first one whose fitness exceeds
    ``confidence`` (registration.cpp:284-290). The chunked path restores
    that cost profile on device: hypotheses are generated, solved and
    exactly scored ``hyp_chunk`` at a time inside a ``lax.while_loop`` that
    stops after the first chunk containing an exceeding hypothesis — easy
    scenes pay for ONE chunk instead of all ``max_iterations`` (the
    prefix-best semantics are preserved exactly: within the exceed chunk
    only the prefix up to the first exceed competes, and across chunks the
    earliest of equal-fitness winners is kept). 'auto' enables it whenever
    scoring is single-stage and there is more than one chunk; the
    hypothesis stream differs from the one-shot path (per-chunk derived
    keys), the same class of delta as any reseeding. ``hyp_chunk='auto'``
    targets four chunks (min 16384): few chunks keep the per-chunk fixed
    cost low, while the split still cuts the cost of
    confidence-exceeding easy scenes.

    ``sampling``: how the 3-point samples are DRAWN (chunked path only).
    'gather' mirrors the reference (3 iid valid-row indices per
    hypothesis, duplicate draws consume their iteration,
    registration.cpp:239-240) — but its (h,3,6) random gather is the
    chunk's cost center. 'rotation' is gather-free: valid rows are compacted once
    (one n-row gather), then epoch e pairs row i with rows
    (i+r1_e) mod count and (i+r2_e) mod count, each mod-count roll one
    contiguous dynamic_slice of a doubled plane-major table
    (solve_rotation_chunk) —
    r1≠r2≠0 by construction, so every triple is distinct-index
    (duplicate rejection becomes structural) and every valid triple
    consumes exactly one iteration id (ids are a cumsum of valid rows,
    carried across chunks, so the max_iterations budget is delivered
    exactly; the loop bound scales with the cloud's valid fraction so
    mostly-padding subset views still get the full budget).
    Within an epoch all triples share (r1, r2) — offsets are uniform
    over the compacted (spatially sorted) rows, so triples stay
    wide-baseline; the stream is a different RNG design from the
    reference's mt19937, the same delta class as any reseeding
    (AB_STATS gates pose/fitness parity across seeds). 'auto' picks
    'rotation' when the chunked path is active and n >= 2048 (epoch
    count stays small), else 'gather'."""
    voxel_size = jnp.asarray(voxel_size, jnp.float32)
    thr2 = (voxel_size * 1.5) ** 2  # registration.cpp:213, strict < on err
    n = source.capacity
    key = jax.random.PRNGKey(seed)
    if hyp_chunk == "auto":
        # Four chunks (min 16384): easy scenes exceed the confidence in
        # chunk 1, so the early exit pays for ONE chunk and a smaller
        # chunk is direct savings there; below four, per-chunk fixed cost
        # takes over. Exhaustive (noisy) scenes pay a few more chunk
        # fixed costs.
        quarter = -(-max_iterations // 4)
        hyp_chunk = max(16384, (quarter + 1023) // 1024 * 1024)

    src_pts = source.points
    src_mask = source.mask
    src_desc = source_features.descriptors
    # Explicit 'subsample' with a small cloud falls back to exact (a
    # stride below 2 would be degenerate, and the subset would cover the
    # whole cloud anyway).
    use_sub = (
        corr_mode in ("subsample", "auto") and n >= 2 * corr_cap
    )
    if use_sub:
        # Strided decimation, not a random-row gather: row k of the subset
        # is source row k*stride — a reshape + major-axis slice, a strided
        # copy instead of a random gather. Source row order is
        # sensor/raster order, so a factor-nudged stride (see
        # decimation_stride) is spatially uniform; the subset keeps its
        # own mask and fitness normalizes by the subset's valid count, so
        # validity stays unbiased. Trailing rows past cap*stride are
        # never sampled (statistically immaterial at 8k draws).
        stride = decimation_stride(n, corr_cap)
        take = stride * corr_cap
        src_pts = src_pts[:take].reshape(corr_cap, stride, 3)[:, 0, :]
        src_mask = src_mask[:take].reshape(corr_cap, stride)[:, 0]
        src_desc = src_desc[:take].reshape(
            corr_cap, stride, src_desc.shape[1]
        )[:, 0, :]
        n = corr_cap

    n_valid = jnp.sum(src_mask.astype(jnp.float32))
    corr = feature_correspondences(
        FPFHFeatures(descriptors=src_desc, mask=src_mask), target_features
    )  # (N,)
    p = src_pts.astype(jnp.float32)
    q = target.points[corr].astype(jnp.float32)

    # --- hypothesis sampling machinery (valid indices only) -----------------
    h_total = -(-max_iterations // chunk) * chunk  # pad to chunk multiple
    perm = jnp.argsort(~src_mask, stable=True)  # valid rows first
    count = jnp.maximum(jnp.sum(src_mask.astype(jnp.int32)), 1)
    pq_packed = jnp.concatenate([p, q], axis=1)  # (N, 6) for 1-gather draws

    def solve_hypotheses(kc, h, first_id):
        """Sample ``h`` 3-point hypotheses (duplicate indices rejected,
        registration.cpp:239-240), QCP-solve, and pack the rank-15 scoring
        factors. Returns (w16t (16,h), t_norm (h,), disabled (h,)); the
        winning transform is recovered from the w16 column (rows 3-5 = t,
        6-14 = vec(R)). One (h,3) row gather rather than 18 one-dim
        coordinate gathers."""
        draws = jax.random.randint(kc, (h, 3), 0, count)
        dup = (
            (draws[:, 0] == draws[:, 1])
            | (draws[:, 1] == draws[:, 2])
            | (draws[:, 0] == draws[:, 2])
        )
        ids = first_id + jnp.arange(h)
        disabled = dup | (ids >= max_iterations)
        sample_idx = perm[draws]  # (h, 3) indices into capacity rows
        # ONE (h, 3, 6) gather from the packed p‖q rows instead of two
        # (h, 3, 3) gathers — the gather is the chunk's cost center, and
        # its cost is per-row, not per-column.
        s6 = pq_packed[sample_idx]
        # Closed-form QCP solve — no batched SVD (registration.cpp:254-262).
        Rs, ts = kabsch_quat(s6[..., :3], s6[..., 3:])
        w16t, t_norm = pack_hypotheses(Rs, ts)
        return w16t, t_norm, disabled

    def solve_hypotheses_rotation(kc, h, first_id):
        """Gather-free 3-point sampling: delegates to the module-level
        :func:`solve_rotation_chunk` (shared with the hypothesis-sharded
        path, tpu3d/parallel/ransac_sharded.py) over the ``pq2p`` table
        built once below."""
        w16t, t_norm, disabled, _, n_cons = solve_rotation_chunk(
            kc, h, first_id, pq2p, count, max_iterations
        )
        return w16t, t_norm, disabled, n_cons

    # --- point-side scoring factors (hypothesis independent) ----------------
    feat_t, pq_norm = build_scoring_factors(p, q, src_mask)

    def score_all(feat_s, pq_s, w_s, tn_s):
        """feat_s (16, N) K-major; w_s (16, H) K-major."""
        return score_w16(feat_s, pq_s, w_s, tn_s, thr2, chunk=chunk)

    sub_n = 16384
    finalists = min(1024, h_total)
    if two_stage == "auto":
        two_stage = n >= 2 * sub_n and h_total > 4 * finalists
    if early_exit == "auto":
        use_chunked = (not two_stage) and max_iterations > hyp_chunk
    else:
        use_chunked = (
            bool(early_exit)
            and not two_stage
            and max_iterations > hyp_chunk
        )

    # Rotation sampling needs the chunked path AND hyp_chunk >= n: with a
    # short chunk only the first hyp_chunk compacted rows would ever fill
    # slot 1 (a spatial bias — compacted order is spatially sorted).
    # n >= 2048 bounds the unrolled epoch count.
    if sampling == "auto":
        use_rotation = use_chunked and hyp_chunk >= n >= 2048
    elif sampling == "rotation":
        use_rotation = use_chunked and hyp_chunk >= n
    else:
        use_rotation = False
    # Mod-count roll table (see build_rotation_table) — built once per call.
    pq2p = (
        build_rotation_table(pq_packed, src_mask, count)
        if use_rotation
        else None
    )

    if use_chunked:
        # --- sequential-chunk evaluation with the reference's early exit ----
        n_chunks = -(-max_iterations // hyp_chunk)
        if use_rotation:
            # Rotation sampling delivers `count`-proportional (not
            # hyp_chunk) iterations per chunk — the SAME number every
            # chunk (vv depends only on count): full epochs contribute
            # `count` each, the truncated tail min(rem, count). Bound the
            # loop by exactly the chunks needed to deliver the full
            # max_iterations budget at the cloud's actual valid fraction
            # (a static 2x headroom silently under-delivered hypotheses
            # whenever the valid fraction was below 0.5 — e.g. sparse
            # subset views that are mostly bucket padding).
            cons = (hyp_chunk // n) * count + jnp.minimum(
                hyp_chunk % n, count
            )
            n_chunks_bound = (
                jnp.int32(max_iterations) + cons - 1
            ) // jnp.maximum(cons, 1)
        else:
            n_chunks_bound = jnp.int32(n_chunks)
        max_it = jnp.int32(max_iterations)
        hyp_key = jax.random.fold_in(key, 7)
        id_w16 = jnp.concatenate(
            [
                jnp.zeros((6,), jnp.float32),
                jnp.eye(3, dtype=jnp.float32).reshape(9),
                jnp.zeros((1,), jnp.float32),
            ]
        )
        # In-chunk two-stage scoring: estimate every hypothesis on a
        # strided ``est_cap``-point subset (σ ≈ 1.1% at 2048), exact-score
        # only the chunk's top finalists. The early-exit cutoff and the
        # winner PICK run on estimates (the same documented delta as
        # ``two_stage``); the winner's reported fitness/rmse are exact.
        # n >= 2*est_cap (not 4x): at the sparse-prepare bench shape the
        # source IS a 4096-row subset view, and exact-scoring 100k
        # hypotheses on it costs ~2x the est-on-2048 + exact-top-32 path
        # for no statistical benefit (the subset fitness is already an
        # estimate of the full cloud; est granularity 1/2048 ≈ 0.05% is
        # far below the 0.999-confidence exceed margin). AB_STATS gates
        # the winner-miss/Δfitness of this arm across 20 seeds.
        use_est = n >= 2 * est_cap
        if use_est:
            st_e = decimation_stride(n, est_cap)
            tke = st_e * est_cap
            p_e = p[:tke].reshape(est_cap, st_e, 3)[:, 0]
            q_e = q[:tke].reshape(est_cap, st_e, 3)[:, 0]
            m_e = src_mask[:tke].reshape(est_cap, st_e)[:, 0]
            feat_e, pq_e = build_scoring_factors(p_e, q_e, m_e)
            n_valid_e = jnp.maximum(jnp.sum(m_e.astype(jnp.float32)), 1.0)
            # 32 finalists: the exact rescore is a (16,N)x(16,32) matmul
            # — free. Measured (AB_STATS 20 seeds): doubling from 16
            # does NOT move the winner miss rate — the ~1e-3 fitness
            # deltas come from sigma-class estimate-rank outliers far
            # below any practical k, not near-top ties; kept at 32 for
            # margin since it costs nothing.
            k_fin = min(32, hyp_chunk)

        def body(state):
            c, fid, _, bf, br, bw = state
            if use_rotation:
                w16t, t_norm, disabled, n_cons = solve_hypotheses_rotation(
                    jax.random.fold_in(hyp_key, c), hyp_chunk, fid
                )
            else:
                w16t, t_norm, disabled = solve_hypotheses(
                    jax.random.fold_in(hyp_key, c), hyp_chunk, fid
                )
                n_cons = jnp.int32(hyp_chunk)
            if use_est:
                cnt_e, _ = score_all(feat_e, pq_e, w16t, t_norm)
                fitness = jnp.where(disabled, -1.0, cnt_e / n_valid_e)
            else:
                cnt, errsum = score_all(feat_t, pq_norm, w16t, t_norm)
                fitness = jnp.where(
                    disabled, -1.0, cnt / jnp.maximum(n_valid, 1.0)
                )
            # Early-exit prefix within the chunk (registration.cpp:284-290).
            exceed = fitness > confidence
            any_ex = jnp.any(exceed)
            cutoff = jnp.where(any_ex, jnp.argmax(exceed), hyp_chunk - 1)
            mf = jnp.where(jnp.arange(hyp_chunk) <= cutoff, fitness, -2.0)
            if use_est:
                # Exact rescore of the estimate top-k; ties in the exact
                # pass resolve in estimate-rank order (statistical-delta
                # class, like every other subsample decision here).
                _, topk = jax.lax.top_k(mf, k_fin)
                cnt_x, err_x = score_all(
                    feat_t, pq_norm, w16t[:, topk], t_norm[topk]
                )
                fit_x = jnp.where(
                    mf[topk] <= -1.0, mf[topk],
                    cnt_x / jnp.maximum(n_valid, 1.0),
                )
                bi = jnp.argmax(fit_x)
                lb = topk[bi]
                lf = fit_x[bi]
                lr = jnp.where(
                    cnt_x[bi] > 0,
                    jnp.sqrt(err_x[bi] / jnp.maximum(cnt_x[bi], 1.0)),
                    999.0,
                )
            else:
                lb = jnp.argmax(mf)  # first of equals == strict >
                lf = mf[lb]
                lr = jnp.where(
                    cnt[lb] > 0,
                    jnp.sqrt(errsum[lb] / jnp.maximum(cnt[lb], 1.0)),
                    999.0,
                )
            better = lf > bf  # strict: the earliest chunk keeps ties
            return (
                c + 1,
                fid + n_cons,
                any_ex,
                jnp.where(better, lf, bf),
                jnp.where(better, lr, br),
                jnp.where(better, w16t[:, lb], bw),
            )

        def cond(state):
            c, fid, done = state[0], state[1], state[2]
            keep = (
                (c < n_chunks_bound) & (fid < max_it)
                & jnp.logical_not(done)
            )
            if use_rotation:
                # count < 3 disables EVERY rotation triple (a 3-point
                # sample cannot exist) — exit immediately with the
                # fitness-0 identity instead of burning chunks whose
                # hypotheses are all masked (the reference's equivalent:
                # every draw is a duplicate-rejected no-op).
                keep = keep & (count >= 3)
            return keep

        state0 = (
            jnp.int32(0),
            jnp.int32(0),
            jnp.bool_(False),
            jnp.float32(0.0),  # reference best_fitness default
            jnp.float32(0.0),
            id_w16,
        )
        # Chunk 1 is PEELED out of the while_loop: it always runs
        # (n_chunks_bound >= 1, max_it >= 1; the count < 3 case disables
        # every hypothesis, so the body provably leaves the carried best
        # at the init state — result-identical), and inlining it lets XLA
        # fuse the first chunk's sampling/solve/score chain with the
        # surrounding graph instead of walling it behind the loop. Easy
        # scenes exceed the confidence in chunk 1, so the remaining loop
        # then runs ZERO iterations.
        state1 = body(state0)
        _, _, _, best_fitness, best_rmse, bw = jax.lax.while_loop(
            cond, body, state1
        )
        # w16 = [Rᵀt | t | vec(R) | 0] — recover the winning transform.
        best_R = bw[6:15].reshape(3, 3)
        best_t = bw[3:6]
    elif two_stage:
        w16t, t_norm, disabled = solve_hypotheses(key, h_total, 0)
        h_ids = jnp.arange(h_total)
        # Stage 1: estimate fitness on a random point subsample.
        skey = jax.random.fold_in(key, 1)
        rows = perm[jax.random.randint(skey, (sub_n,), 0, count)]
        cnt1, _ = score_all(feat_t[:, rows], pq_norm[rows], w16t, t_norm)
        fit1 = jnp.where(disabled, -1.0, cnt1 / sub_n)
        # Early-exit prefix on the estimates (registration.cpp:284-290).
        exceed = fit1 > confidence
        cutoff = jnp.where(jnp.any(exceed), jnp.argmax(exceed), h_total - 1)
        allowed = h_ids <= cutoff
        fit1 = jnp.where(allowed, fit1, -2.0)
        # Stage 2: exact scoring of the finalists.
        _, top_idx = jax.lax.top_k(fit1, finalists)
        cnt2, err2sum = score_all(
            feat_t, pq_norm, w16t[:, top_idx], t_norm[top_idx]
        )
        fit2 = jnp.where(
            fit1[top_idx] <= -1.0, -1.0, cnt2 / jnp.maximum(n_valid, 1.0)
        )
        best_f = jnp.argmax(fit2)
        best = top_idx[best_f]
        best_fitness = fit2[best_f]
        best_rmse = jnp.where(
            cnt2[best_f] > 0,
            jnp.sqrt(err2sum[best_f] / jnp.maximum(cnt2[best_f], 1.0)),
            999.0,
        )
        bw = w16t[:, best]
        best_R = bw[6:15].reshape(3, 3)
        best_t = bw[3:6]
    else:
        w16t, t_norm, disabled = solve_hypotheses(key, h_total, 0)
        h_ids = jnp.arange(h_total)
        cnt, errsum = score_all(feat_t, pq_norm, w16t, t_norm)
        fitness = jnp.where(disabled, -1.0, cnt / jnp.maximum(n_valid, 1.0))
        rmse = jnp.where(
            cnt > 0, jnp.sqrt(errsum / jnp.maximum(cnt, 1.0)), 999.0
        )
        # --- early-exit prefix semantics (registration.cpp:284-290) --------
        exceed = fitness > confidence
        any_exceed = jnp.any(exceed)
        first_exceed = jnp.argmax(exceed)  # first True (0 if none — guarded)
        cutoff = jnp.where(any_exceed, first_exceed, h_total - 1)
        allowed = h_ids <= cutoff
        masked_fitness = jnp.where(allowed, fitness, -2.0)
        best = jnp.argmax(masked_fitness)  # first of equals == strict >
        best_fitness = fitness[best]
        best_rmse = rmse[best]
        bw = w16t[:, best]
        best_R = bw[6:15].reshape(3, 3)
        best_t = bw[3:6]

    # Direct winner rescore (registration.cpp:270-282): the rank-16
    # scoring expansion err2 = F·W + |p|²+|q|² + |t|² is fine for
    # SELECTING among 100k hypotheses, but its f32 cancellation floor
    # (~3e-4, worse under Mosaic FMA ordering) pollutes the REPORTED
    # rmse of near-exact registrations. One direct residual pass over
    # the single winner is free and reproduces the reference's
    # computation exactly; selection above (and `won`) stays
    # expansion-based.
    dr = p @ best_R.T + best_t - q  # (N, 3)
    err2_d = jnp.sum(dr * dr, axis=1)
    inl_d = src_mask & (err2_d < thr2)
    cnt_d = jnp.sum(inl_d.astype(jnp.float32))
    # `won` requires BOTH scorings to beat the 0-fitness default: the
    # expansion and the direct residual can disagree at the inlier
    # threshold under f32 cancellation (~3e-4), and expansion-won +
    # direct-0 would otherwise return a junk pose labeled fitness 0.0 /
    # rmse 999 — a combination the reference can never produce. Demoting
    # to the identity/0/0 default keeps the output in the reference's
    # reachable set (boundary-noise delta class).
    won = (best_fitness > 0.0) & (cnt_d > 0)
    best_fitness = cnt_d / jnp.maximum(n_valid, 1.0)
    best_rmse = jnp.where(
        cnt_d > 0,
        jnp.sqrt(
            jnp.sum(jnp.where(inl_d, err2_d, 0.0))
            / jnp.maximum(cnt_d, 1.0)
        ),
        999.0,
    )

    T = make_transform(best_R, best_t)
    return RegistrationResult(
        transformation=jnp.where(won, T, jnp.eye(4, dtype=jnp.float32)),
        fitness=jnp.where(won, best_fitness, 0.0),
        rmse=jnp.where(won, best_rmse, 0.0),
    )
