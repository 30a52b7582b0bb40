"""Streaming CP (port of ``repro.methods.streaming``): fold newly arrived
nonzeros into existing factors, with the session's state quantized to
bucket caps.

``StreamingCP`` is stateful: a session holds the accumulated nonzero set
and the current factor state, and ``update(delta)`` merges the new
nonzeros and runs a few warm-started refinement sweeps from the current
factors (``init_state`` through ``core.als_device.cpd_als_fused``, or the
batched service behind a runner) instead of a cold refit.

  * **bucket-quantized fit inputs** -- every fit sees the session tensor
    padded to a monotone bucket cap (``core.plan.session_cap`` over the
    session's ``BucketPolicy``; zero values at the origin, weight 0 for
    weighted methods).  On the segment backend the padding is bitwise a
    no-op.  On the slab kernel every padding entry lands in row block 0 of
    every mode and changes that block's slabs and chunk grouping, so
    results agree with the unpadded fit to float32 tolerance.  The cap
    only grows.
  * **incremental sorted merge** -- coordinates stay in canonical
    (linearized-key) order and each delta folds in with an O(nnz + m)
    two-``searchsorted`` merge; at duplicate coordinates values and
    confidence weights add, the session entry first.
  * **confidence-decay eviction** -- with ``decay`` set, per-entry weights
    are multiplied by it every increment, and when a merge would cross
    into a larger bucket, entries whose weight fell below
    ``weight_floor`` are dropped first.  For weighted-fit inner methods
    the decayed weights are the fit's confidences; for cp/nncp they are
    bookkeeping only.
  * **durable sessions** -- ``save()`` / ``restore()`` go through
    ``checkpoint.manager.CheckpointManager``'s atomic commit; the
    snapshot is host numpy, so a session restores onto any device.

The inner method is pluggable (``method="cp"``, ``"nncp"``,
``"masked"``; masked sessions accept per-entry ``weights``).  The fit
runs on ``backend="slab"`` (the kernel) unless asked otherwise.  Routed
through ``runtime.ALSRunner`` (``runner=`` or ``ALSRunner.open_stream()``)
every fit goes through the runner's front door and each increment is
recorded in the service metrics.  Each ``start``/``update`` emits a
``stream.increment`` trace event.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..core import plan as plan_mod
from ..core.coo import SparseTensor, _linearize
from ..device import resolve_device
from ..obs import clock as obs_clock
from ..obs import trace as obs_trace
from .registry import MethodSpec, get_method, register_method

_SESSION_IDS = itertools.count()


def _canonical(indices: np.ndarray, values: np.ndarray,
               weights: np.ndarray | None, shape):
    """Canonicalize one COO list: sort by linearized key; values AND
    confidence weights sum at duplicate coordinates (same stable order as
    ``SparseTensor.deduplicate``).  Returns ``(keys, idx, vals, wts)``
    with ``wts`` None when ``weights`` is None."""
    keys = _linearize(indices, shape)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    vals = values[order].astype(np.float32)
    wts = weights[order].astype(np.float32) if weights is not None else None
    n = len(keys)
    if n == 0:
        return keys, indices[order], vals, wts
    uniq = np.empty(n, dtype=bool)
    uniq[:1] = True
    uniq[1:] = keys[1:] != keys[:-1]
    if uniq.all():
        return keys, indices[order], vals, wts
    starts = np.flatnonzero(uniq)
    vals = np.add.reduceat(vals, starts)
    if wts is not None:
        wts = np.add.reduceat(wts, starts)
    return keys[starts], indices[order][starts], vals, wts


def _merge_sorted(keys_a, idx_a, vals_a, w_a, keys_b, idx_b, vals_b, w_b):
    """O(nnz + m) fold of a canonical delta (b) into the canonical session
    list (a): element positions come from two ``searchsorted`` passes
    instead of re-argsorting the entire history, and the value and
    weight vectors merge in the same pass.  At duplicate coordinates
    values (and weights) ADD with the session entry first: the result is
    bitwise ``_canonical`` of the two canonical lists concatenated.  It is
    not ``_canonical`` of the raw inputs concatenated where a coordinate
    repeats within one side, since those repeats were summed first."""
    na, nb = len(keys_a), len(keys_b)
    pos_a = np.arange(na, dtype=np.int64) + np.searchsorted(
        keys_b, keys_a, side="left")
    pos_b = np.arange(nb, dtype=np.int64) + np.searchsorted(
        keys_a, keys_b, side="right")
    n = na + nb
    keys = np.empty(n, dtype=np.int64)
    keys[pos_a] = keys_a
    keys[pos_b] = keys_b
    idx = np.empty((n, idx_a.shape[1]), dtype=idx_a.dtype)
    idx[pos_a] = idx_a
    idx[pos_b] = idx_b
    vals = np.empty(n, dtype=np.float32)
    vals[pos_a] = vals_a
    vals[pos_b] = vals_b
    wts = None
    if w_a is not None:
        wts = np.empty(n, dtype=np.float32)
        wts[pos_a] = w_a
        wts[pos_b] = w_b
    uniq = np.empty(n, dtype=bool)
    uniq[:1] = True
    uniq[1:] = keys[1:] != keys[:-1]
    if uniq.all():
        return keys, idx, vals, wts
    starts = np.flatnonzero(uniq)
    vals = np.add.reduceat(vals, starts)
    if wts is not None:
        wts = np.add.reduceat(wts, starts)
    return keys[starts], idx[starts], vals, wts


class StreamingCP:
    """Incremental CP session over a growing (bounded, bucket-resident)
    nonzero set.

    policy       -- ``"auto"`` (default): quantize the session's fit-time
                    nnz to geometric buckets (growth 1.5); a
                    ``serve.buckets.BucketPolicy`` to choose the rule;
                    ``None`` to disable quantization (every fit sees the
                    exact nnz).
    decay        -- EWMA factor in (0, 1]: per-entry weights are
                    multiplied by it every increment (re-observations
                    add fresh mass).  None (default) disables decay.
    weight_floor -- entries whose decayed weight falls below this are
                    evicted when a merge would grow the bucket.  0
                    (default) never evicts.
    session_id   -- metrics key; autogenerated when omitted.
    device       -- where fits run without a runner (default the card;
                    raises without it).  A runner brings its own.
    """

    def __init__(self, rank: int, *, method: str = "cp",
                 backend: str = "slab", kappa: int = 1,
                 check_every: int = 2, refine_iters: int = 2,
                 solver: str = "auto", runner=None,
                 policy="auto", decay: float | None = None,
                 weight_floor: float = 0.0,
                 session_id: str | None = None, device="cuda"):
        inner = get_method(method)
        if inner.stateful:
            raise ValueError(
                f"streaming wraps a sweep-based method, got {method!r}")
        if decay is not None and not (0.0 < float(decay) <= 1.0):
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if weight_floor < 0.0:
            raise ValueError(f"weight_floor must be >= 0, got {weight_floor}")
        self.rank = int(rank)
        self.method = method
        self.backend = backend
        self.kappa = int(kappa)
        self.check_every = int(check_every)
        self.refine_iters = int(refine_iters)
        self.solver = solver
        self.runner = runner
        self.device = (runner.device if runner is not None
                       else resolve_device(device))
        if policy == "auto":
            from ..serve.buckets import BucketPolicy

            policy = BucketPolicy(mode="geometric", growth=1.5)
        self.policy = policy
        self.decay = None if decay is None else float(decay)
        self.weight_floor = float(weight_floor)
        self.session_id = (session_id if session_id is not None
                           else f"stream-{next(_SESSION_IDS)}")
        self.seed = 0
        self.increments = 0
        self.evictions = 0
        self.merge_seconds = 0.0
        self._latencies: list[float] = []
        self._shape: tuple[int, ...] | None = None
        self._keys: np.ndarray | None = None
        self._idx: np.ndarray | None = None
        self._vals: np.ndarray | None = None
        self._entry_w: np.ndarray | None = None
        self._cap = 0                      # 0 = no quantization (policy=None)
        self._state = None
        self._result = None

    # -- substrate dispatch -------------------------------------------------

    @property
    def _weighted(self) -> bool:
        return get_method(self.method).weighted_fit

    def _fit_inputs(self):
        """The (tensor, weights) pair a refinement actually fits: the
        session's canonical set, padded to the monotone bucket cap with
        zero-valued (weight-0 for weighted methods) entries, so that
        successive increments inside a bucket present one nnz class."""
        tensor = SparseTensor(self._idx, self._vals, self._shape)
        fit_w = (self._entry_w
                 if self._weighted and self._entry_w is not None else None)
        if self._cap and tensor.nnz < self._cap:
            from ..serve.buckets import pad_tensor, pad_weights

            if fit_w is not None:
                fit_w = pad_weights(fit_w, self._cap)
            tensor = pad_tensor(tensor, self._cap)
        return tensor, fit_w

    def _fit(self, n_iters, tol, seed, init_state):
        tensor, fit_w = self._fit_inputs()
        if self.runner is not None:
            return self.runner.decompose(
                tensor, n_iters=n_iters, tol=tol, seed=seed,
                method=self.method, init_state=init_state, weights=fit_w)
        from ..core.als_device import cpd_als_fused

        return cpd_als_fused(
            tensor, self.rank, kappa=self.kappa, n_iters=n_iters, tol=tol,
            seed=seed, backend=self.backend, check_every=self.check_every,
            solver=self.solver, method=self.method, init_state=init_state,
            weights=fit_w, device=self.device)

    def _check_weighted(self):
        if not self._weighted:
            raise ValueError(
                f"streaming weights require a weighted-fit inner method "
                f"(e.g. 'masked'), got {self.method!r}")

    def _absorb(self, res):
        from ..core.als_device import state_from_factors

        self._result = res
        self._state = state_from_factors(res.factors, res.weights)
        return res

    def _update_cap(self):
        if self.policy is not None:
            self._cap = plan_mod.session_cap(len(self._keys), self._cap,
                                             self.policy)

    def _maybe_evict(self) -> int:
        """Confidence-decay eviction at bucket boundaries: when the merged
        nnz would cross into a LARGER bucket, drop entries whose decayed
        weight sits below the floor first — often that keeps the session
        inside its current bucket, and always bounds residency for
        unbounded streams."""
        if (self._entry_w is None or self.weight_floor <= 0.0
                or self.policy is None):
            return 0
        if plan_mod.session_cap(len(self._keys), self._cap,
                                self.policy) <= self._cap:
            return 0                     # still inside the bucket
        keep = self._entry_w >= np.float32(self.weight_floor)
        n_evict = int(keep.size - int(keep.sum()))
        if n_evict:
            self._keys = self._keys[keep]
            self._idx = self._idx[keep]
            self._vals = self._vals[keep]
            self._entry_w = self._entry_w[keep]
            self.evictions += n_evict
        return n_evict

    def _record_increment(self, wall_s: float, merge_s: float, evicted: int,
                          count: bool = True):
        if count:
            self._latencies.append(wall_s)
        obs_trace.event(
            "stream.increment", cat="serve", session=self.session_id,
            nnz=len(self._keys), bucket_cap=self._cap or len(self._keys),
            evicted=evicted, wall_s=round(wall_s, 6),
            merge_s=round(merge_s, 6), counted=count)
        if self.runner is not None and getattr(self.runner, "service", None):
            self.runner.service.metrics.record_stream_increment(
                self.session_id, bucket_cap=self._cap or len(self._keys),
                nnz=len(self._keys), evicted=evicted, wall_s=wall_s,
                merge_s=merge_s, count=count)

    # -- public API ---------------------------------------------------------

    def start(self, tensor: SparseTensor, *, n_iters: int = 25,
              tol: float = 1e-5, seed: int = 0,
              weights: np.ndarray | None = None):
        """Cold fit on the initial nonzero set.  ``weights`` — per-entry
        observation confidences (weighted-fit inner methods only); at
        duplicate coordinates confidence mass sums alongside values.
        ``seed`` is the SESSION seed: it also threads through every warm
        refinement, so a restored session refines identically to an
        uninterrupted one."""
        self.increments = 0
        self.evictions = 0
        self.merge_seconds = 0.0
        self._latencies = []
        self.seed = int(seed)
        w = None
        if weights is not None:
            self._check_weighted()
            w = np.asarray(weights, np.float32)
        elif self.decay is not None:
            w = np.ones(tensor.nnz, np.float32)
        t0 = obs_clock.now()
        self._shape = tuple(int(s) for s in tensor.shape)
        self._keys, self._idx, self._vals, self._entry_w = _canonical(
            tensor.indices, tensor.values, w, self._shape)
        self._cap = 0
        self._update_cap()
        merge_s = obs_clock.now() - t0
        self.merge_seconds += merge_s
        res = self._absorb(self._fit(n_iters, tol, self.seed, None))
        # register residency gauges, but the cold fit is NOT an increment
        self._record_increment(obs_clock.now() - t0, merge_s, 0,
                               count=False)
        return res

    def update(self, delta: SparseTensor, *, refine_iters: int | None = None,
               tol: float = -1.0, weights: np.ndarray | None = None):
        """Fold ``delta``'s nonzeros in (values at duplicate coordinates
        ADD — the streaming-accumulation semantics; confidence weights
        add too) and refine the current factors with ``refine_iters``
        warm sweeps.  A weighted stream stays weighted: increments
        without ``weights`` arrive at confidence 1 per entry.  With
        ``decay`` set, existing weights are EWMA-decayed first and
        below-floor entries are evicted at bucket boundaries."""
        if self._keys is None:
            raise RuntimeError("call start() before update()")
        if tuple(delta.shape) != self._shape:
            raise ValueError(
                f"increment shape {tuple(delta.shape)} != stream shape "
                f"{self._shape}")
        t_begin = obs_clock.now()
        w_new = None
        if weights is not None:
            self._check_weighted()
            w_new = np.asarray(weights, np.float32)
        track = (w_new is not None or self._entry_w is not None
                 or self.decay is not None)
        if track:
            if self._entry_w is None:
                self._entry_w = np.ones(len(self._keys), np.float32)
            if self.decay is not None:
                self._entry_w = self._entry_w * np.float32(self.decay)
            if w_new is None:
                w_new = np.ones(delta.nnz, np.float32)
        dk, di, dv, dw = _canonical(delta.indices, delta.values, w_new,
                                    self._shape)
        self._keys, self._idx, self._vals, self._entry_w = _merge_sorted(
            self._keys, self._idx, self._vals, self._entry_w,
            dk, di, dv, dw)
        evicted = self._maybe_evict()
        self._update_cap()
        merge_s = obs_clock.now() - t_begin
        self.merge_seconds += merge_s
        self.increments += 1
        k = self.refine_iters if refine_iters is None else int(refine_iters)
        res = self._absorb(self._fit(k, tol, self.seed, self._state))
        self._record_increment(obs_clock.now() - t_begin, merge_s,
                               evicted)
        return res

    # -- durability ---------------------------------------------------------

    _CKPT_KIND = "streaming_cp"
    _CKPT_VERSION = 1

    def save(self, directory, *, step: int | None = None, keep: int = 3):
        """Durably snapshot the session (tensor, weights, factor state,
        decay clock, config) through the checkpoint manager's
        atomic-commit machinery: the snapshot is visible only after its
        commit marker renames into place, so a crash mid-save never
        leaves a restorable torn session.  ``step`` defaults to the
        increment counter, so keep-k GC retains the k most recent
        increments.  Returns the manager (reusable for later saves)."""
        from ..checkpoint.manager import CheckpointManager

        if self._keys is None:
            raise RuntimeError("nothing to save before start()")
        mgr = (directory if isinstance(directory, CheckpointManager)
               else CheckpointManager(str(directory), keep=keep,
                                      async_save=False))
        factors, _, lam = self._state
        tree = {
            "idx": self._idx,
            "vals": self._vals,
            "keys": self._keys,
            "entry_w": (self._entry_w if self._entry_w is not None
                        else np.zeros((0,), np.float32)),
            "factors": {str(d): np.asarray(F) for d, F in enumerate(factors)},
            "lam": np.asarray(lam),
        }
        pol = None
        if self.policy is not None:
            pol = {"mode": self.policy.mode, "quantum": self.policy.quantum,
                   "growth": self.policy.growth,
                   "min_cap": self.policy.min_cap}
        extra = {
            "kind": self._CKPT_KIND, "version": self._CKPT_VERSION,
            "rank": self.rank, "method": self.method,
            "backend": self.backend, "kappa": self.kappa,
            "check_every": self.check_every,
            "refine_iters": self.refine_iters, "solver": self.solver,
            "shape": list(self._shape), "seed": self.seed,
            "increments": self.increments, "evictions": self.evictions,
            "decay": self.decay, "weight_floor": self.weight_floor,
            "cap": int(self._cap),
            "has_entry_w": self._entry_w is not None,
            "policy": pol, "session_id": self.session_id,
        }
        mgr.save(self.increments if step is None else int(step), tree,
                 extra=extra, block=True)
        return mgr

    @classmethod
    def restore(cls, directory, *, step: int | None = None, runner=None,
                device="cuda"):
        """Rebuild a session from its latest (or ``step``-th) committed
        checkpoint.  The restored session refines identically to the
        uninterrupted one: same canonical tensor, weights, factor state,
        session seed, decay clock, and bucket cap.  ``runner`` re-routes
        the restored session and ``device`` places it without one: the
        snapshot is host numpy, so it restores onto any device."""
        from ..checkpoint.manager import CheckpointManager
        from ..core.als_device import state_from_factors

        mgr = (directory if isinstance(directory, CheckpointManager)
               else CheckpointManager(str(directory)))
        arrays, extra = mgr.restore_items(step)
        if extra.get("kind") != cls._CKPT_KIND:
            raise ValueError(
                f"checkpoint in {mgr.dir!r} is not a streaming session "
                f"(kind={extra.get('kind')!r})")
        policy = None
        if extra["policy"] is not None:
            from ..serve.buckets import BucketPolicy

            policy = BucketPolicy(**extra["policy"])
        s = cls(int(extra["rank"]), method=extra["method"],
                backend=extra["backend"], kappa=int(extra["kappa"]),
                check_every=int(extra["check_every"]),
                refine_iters=int(extra["refine_iters"]),
                solver=extra["solver"], runner=runner, policy=policy,
                decay=extra["decay"], weight_floor=extra["weight_floor"],
                session_id=extra.get("session_id"), device=device)
        s._shape = tuple(int(x) for x in extra["shape"])
        s._keys = arrays["keys"]
        s._idx = arrays["idx"]
        s._vals = arrays["vals"]
        s._entry_w = arrays["entry_w"] if extra["has_entry_w"] else None
        s._cap = int(extra["cap"])
        s.seed = int(extra["seed"])
        s.increments = int(extra["increments"])
        s.evictions = int(extra["evictions"])
        factors = [arrays[f"factors/{d}"] for d in range(len(s._shape))]
        s._state = state_from_factors(factors, arrays["lam"])
        return s

    # -- read side ----------------------------------------------------------

    @property
    def tensor(self) -> SparseTensor | None:
        """The UNPADDED accumulated tensor in canonical key order (the
        bucket padding exists only at fit time)."""
        if self._keys is None:
            return None
        return SparseTensor(self._idx, self._vals, self._shape)

    @property
    def entry_weights(self) -> np.ndarray | None:
        """Per-entry confidence mass entering the FIT objective (canonical
        order aligned with ``tensor``); None for an unweighted inner
        method (where any decay weights are eviction bookkeeping only)."""
        if self._weighted:
            return self._entry_w
        return None

    @property
    def session_weights(self) -> np.ndarray | None:
        """The decay/eviction weight track itself (also the fit
        confidences for weighted inner methods); None when untracked."""
        return self._entry_w

    @property
    def bucket_cap(self) -> int:
        """Current fit-time nnz residency class (0 = quantization off)."""
        return self._cap

    def stats(self) -> dict:
        """Per-session gauges (the standalone mirror of what runner-routed
        sessions report into ``serve.metrics``)."""
        lat = np.asarray(self._latencies, dtype=np.float64)
        return {
            "session_id": self.session_id,
            "nnz": 0 if self._keys is None else len(self._keys),
            "bucket_cap": self._cap,
            "increments": self.increments,
            "evictions": self.evictions,
            "merge_seconds": self.merge_seconds,
            "increment_p50_s": float(np.percentile(lat, 50)) if lat.size
            else 0.0,
            "increment_p99_s": float(np.percentile(lat, 99)) if lat.size
            else 0.0,
        }

    @property
    def result(self):
        return self._result

    @property
    def fit(self) -> float:
        if self._result is None or not self._result.fits:
            return float("-inf")
        return self._result.fits[-1]


STREAMING = register_method(MethodSpec(
    name="streaming",
    description="Streaming CP: stateful session folding nonzero increments "
                "into existing factors via warm-started refinement sweeps "
                "(inner method pluggable: cp, nncp, or masked with "
                "accumulating per-entry confidences).  Session state is "
                "bucket-quantized, merged incrementally in O(nnz + m), "
                "bounded by confidence-decay eviction, and durable via "
                "checkpoint save/restore.",
    stateful=True,
    session_factory=StreamingCP,
))
