"""Multi-tenant serving engine for the GPO preference predictor
(DESIGN.md §12); PyTorch port of ``repro/core/serving.py``.

The trained predictor is the paper's product: a group-conditioned reward
model answering "what would group g answer to question q?" under real
query load. The engine:

* **Queue + admission** — ``submit`` appends to a FIFO queue bounded by
  ``ServeConfig.max_queue``; over-capacity submissions are rejected.
* **Continuous batching over ragged lengths** — each ``step`` fuses up
  to ``max_batch`` head-of-line requests into one decode, padded to a
  small static bucket set. The scheduler never reorders, so batch
  composition is a pure function of the queue contents.
* **Prefix cache** — ``gpo_prefill`` output (per-layer context K/V,
  kept on the device) is cached under the request's ``prefix_key`` in an
  LRU of ``cache_entries`` entries; hits skip prefill. Entries are
  prefilled at each request's own ctx bucket, so a hit feeds the decode
  the very tensors a miss would: hit == miss bit for bit.
* **int8 inference** — ``quantize_gpo_params`` rewrites the dense
  weights as ``QuantizedLinear`` at load time and ``core/gpo.py::_mm``
  routes them through the int8 matmul kernel, one launch per weight
  per prefill or decode.

Scheduling depends only on queue order, so a fixed arrival trace yields
a fixed batch composition on any machine; clocks are measurement only.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GPOConfig, ServeConfig
from repro_torch.core.gpo import (
    GPOLayer,
    GPOPrefix,
    gpo_decode,
    gpo_prefill,
    map_params,
)
from repro_torch.kernels import quantize_linear
from repro_torch.kernels.backend import resolve_device

PyTree = Any

# GPOLayer fields that are dense matmul weights (quantized for int8
# serving); the ln1/ln2 RMS-norm scales stay f32.
_QUANT_FIELDS = ("wq", "wk", "wv", "wo", "w1", "w2")


def quantize_gpo_params(params: PyTree) -> PyTree:
    """Load-time int8 quantization of the GPO predictor's dense weights
    (DESIGN.md §12): ``in_proj``, ``head`` and every per-layer matmul
    become ``QuantizedLinear`` (the stacked-layer axis carried into
    per-layer scales); norm scales stay f32."""
    layers = params["layers"]
    qlayers = GPOLayer(**{
        f: (quantize_linear(getattr(layers, f)) if f in _QUANT_FIELDS
            else getattr(layers, f))
        for f in GPOLayer._fields})
    return {
        "in_proj": quantize_linear(params["in_proj"]),
        "layers": qlayers,
        "final_norm": params["final_norm"],
        "head": quantize_linear(params["head"]),
    }


# ---------------------------------------------------------------------------
# request / result / batch-record types
# ---------------------------------------------------------------------------
@dataclass
class Request:
    """One preference query: predict a group's answer distributions for
    ``tgt_x`` given the (ctx_x, ctx_y) in-context examples.
    ``prefix_key`` identifies the shared context for prefix caching —
    two requests with the same key MUST carry identical (ctx_x, ctx_y);
    None disables caching for this request. ``arrival`` is seconds on
    the engine clock. ``deadline`` is an absolute engine-clock time past
    which the scheduler drops the request unserved (counted in
    ``ServeStats.expired``); None means no deadline."""

    rid: int
    ctx_x: np.ndarray  # (m*A, d_embed)
    ctx_y: np.ndarray  # (m*A,)
    tgt_x: np.ndarray  # (t*A, d_embed)
    prefix_key: Optional[Hashable] = None
    arrival: float = 0.0
    deadline: Optional[float] = None  # absolute engine-clock seconds
    meta: Optional[dict] = None  # caller-owned (e.g. group/question ids)


@dataclass
class Completed:
    rid: int
    pred: np.ndarray  # (t, A) rows on the simplex
    cache_hit: bool
    arrival: float
    finished: float
    batch_index: int

    @property
    def latency(self) -> float:
        return self.finished - self.arrival


@dataclass(frozen=True)
class BatchRecord:
    """Composition of one decode dispatch — the deterministic-scheduler
    contract surface."""

    rids: Tuple[int, ...]
    batch_pad: int  # padded batch size (a batch_buckets entry)
    ctx_bucket: int
    tgt_bucket: int
    hits: Tuple[bool, ...]


@dataclass
class ServeStats:
    submitted: int = 0
    rejected: int = 0
    completed: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    prefills: int = 0  # unique contexts actually prefilled
    evictions: int = 0
    expired: int = 0  # dropped unserved: deadline passed while queued


# ---------------------------------------------------------------------------
# batch functions: the batch axis is written out, so one call is one
# launch per weight
# ---------------------------------------------------------------------------
@torch.no_grad()
def _prefill_batch(params, cfg: GPOConfig, ctx_x, ctx_y, ctx_len):
    """(B, M, d), (B, M), (B,) -> GPOPrefix with (B, L, M, nh, hd) K/V."""
    return gpo_prefill(params, cfg, ctx_x, ctx_y, ctx_len=ctx_len)


@torch.no_grad()
def _decode_batch(params, cfg: GPOConfig, num_options: int,
                  pk, pv, ctx_len, tgt_x):
    """(B, L, M, nh, hd) x2, (B,), (B, T, d) -> (B, T/A, A) normalized
    preference rows (the ``predict_preferences`` clip-and-normalize)."""
    mu, _ = gpo_decode(params, cfg, GPOPrefix(k=pk, v=pv), tgt_x,
                       ctx_len=ctx_len)
    scores = mu.reshape(mu.shape[0], -1, num_options).clamp(min=1e-4)
    return scores / scores.sum(dim=-1, keepdim=True)


def _bucket_of(n: int, buckets: Sequence[int], what: str) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{what} length {n} exceeds the largest bucket "
                     f"{buckets[-1]}; grow ServeConfig.{what}_buckets")


class PreferenceServer:
    """The multi-tenant serving engine (module docstring; DESIGN.md §12).

    ``submit`` enqueues (or rejects), ``step`` retires one fused batch,
    ``run_trace`` drives a full arrival trace open-loop and returns the
    completed results with per-request latencies. Weights, cache entries
    and the batch tensors live on ``device`` (CUDA unless the caller
    names another).
    """

    def __init__(self, params: PyTree, gpo_cfg: GPOConfig,
                 serve_cfg: ServeConfig = ServeConfig(), *,
                 num_options: int, device=None):
        serve_cfg.validate()
        for b in serve_cfg.tgt_buckets:
            if b % num_options:
                raise ValueError(
                    f"tgt bucket {b} is not a multiple of "
                    f"num_options={num_options}: padded target rows must "
                    "reshape into whole questions")
        self.device = resolve_device(device)
        self.gcfg = gpo_cfg
        self.scfg = serve_cfg
        self.num_options = num_options
        params = map_params(lambda a: a.to(self.device), params)
        self.params = (quantize_gpo_params(params)
                       if serve_cfg.int8_weights else params)
        self._queue: deque[Request] = deque()
        # prefix_key -> (k (L, Mb, nh, hd), v, ctx_len) at the request's
        # own ctx bucket Mb, on the device
        self._cache: OrderedDict[Hashable, tuple] = OrderedDict()
        self.batches: List[BatchRecord] = []
        self.stats = ServeStats()
        self._clock_start = time.perf_counter()

    # -- clock ----------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._clock_start

    def reset(self, *, clear_cache: bool = True) -> None:
        """Drop queued work, stats, and the batch log (and optionally the
        prefix cache) — between benchmark phases."""
        self._queue.clear()
        self.batches = []
        self.stats = ServeStats()
        if clear_cache:
            self._cache.clear()
        self._clock_start = time.perf_counter()

    # -- admission ------------------------------------------------------
    def submit(self, req: Request) -> bool:
        self.stats.submitted += 1
        if self.scfg.max_queue and len(self._queue) >= self.scfg.max_queue:
            self.stats.rejected += 1
            return False
        self._queue.append(req)
        return True

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- prefix cache ---------------------------------------------------
    def _cache_get(self, key: Hashable):
        if key is None or self.scfg.cache_entries == 0:
            return None
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
        return entry

    def _cache_put(self, key: Hashable, entry) -> None:
        if key is None or self.scfg.cache_entries == 0:
            return
        self._cache[key] = entry
        self._cache.move_to_end(key)
        while len(self._cache) > self.scfg.cache_entries:
            self._cache.popitem(last=False)
            self.stats.evictions += 1

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- one engine step ------------------------------------------------
    def step(self) -> List[Completed]:
        """Retire one fused batch: pop up to ``max_batch`` head-of-line
        requests (dropping any whose ``deadline`` passed, wherever they
        sit in the queue, counted ``expired``), prefill the cache misses
        batched at each request's own ctx bucket, gather everyone's
        prefix K/V, decode once, complete. Live requests keep strict FIFO
        order."""
        now = self.now()
        reqs: List[Request] = []
        while self._queue and len(reqs) < self.scfg.max_batch:
            r = self._queue.popleft()
            if r.deadline is not None and now >= r.deadline:
                self.stats.expired += 1
                continue
            reqs.append(r)
        if not reqs:
            return []
        take = len(reqs)
        ctx_b = _bucket_of(max(r.ctx_x.shape[0] for r in reqs),
                           self.scfg.ctx_buckets, "ctx")
        tgt_b = _bucket_of(max(r.tgt_x.shape[0] for r in reqs),
                           self.scfg.tgt_buckets, "tgt")
        batch_b = _bucket_of(take, self.scfg.batch_buckets, "batch")

        # cache lookups; a miss key shared within the batch prefills once
        entries: dict = {}
        hits: List[bool] = []
        misses: List[Request] = []
        seen_miss_keys: set = set()
        for r in reqs:
            entry = self._cache_get(r.prefix_key)
            if entry is not None:
                hits.append(True)
                entries[id(r)] = entry
                self.stats.cache_hits += 1
            else:
                hits.append(False)
                self.stats.cache_misses += 1
                if r.prefix_key is None or r.prefix_key not in seen_miss_keys:
                    misses.append(r)
                    if r.prefix_key is not None:
                        seen_miss_keys.add(r.prefix_key)

        # batched prefill of the misses, grouped by own ctx bucket
        by_bucket: dict[int, List[Request]] = {}
        for r in misses:
            b = _bucket_of(r.ctx_x.shape[0], self.scfg.ctx_buckets, "ctx")
            by_bucket.setdefault(b, []).append(r)
        fresh: dict = {}
        for b, group in sorted(by_bucket.items()):
            gb = _bucket_of(len(group), self.scfg.batch_buckets, "batch")
            cxs = np.zeros((gb, b, group[0].ctx_x.shape[1]), np.float32)
            cys = np.zeros((gb, b), np.float32)
            lens = np.zeros((gb,), np.int64)
            for i, r in enumerate(group):
                mlen = r.ctx_x.shape[0]
                cxs[i, :mlen] = r.ctx_x
                cys[i, :mlen] = r.ctx_y
                lens[i] = mlen
            pre = _prefill_batch(self.params, self.gcfg, self._tensor(cxs),
                                 self._tensor(cys), self._tensor(lens))
            self.stats.prefills += len(group)
            for i, r in enumerate(group):
                entry = (pre.k[i], pre.v[i], int(lens[i]))
                fresh[r.prefix_key] = entry
                self._cache_put(r.prefix_key, entry)
                if r.prefix_key is None:
                    entries[id(r)] = entry
        for r in reqs:
            if id(r) not in entries:
                entries[id(r)] = fresh[r.prefix_key]

        # gather + pad to the batch buckets, decode once
        ks, vs, lens, txs = [], [], [], []
        for r in reqs:
            k, v, mlen = entries[id(r)]
            pad_m = ctx_b - k.shape[1]
            if pad_m:  # (L, M, nh, hd): pad the M axis with zeros
                k = F.pad(k, (0, 0, 0, 0, 0, pad_m))
                v = F.pad(v, (0, 0, 0, 0, 0, pad_m))
            ks.append(k)
            vs.append(v)
            lens.append(mlen)
            tx = np.zeros((tgt_b, r.tgt_x.shape[1]), np.float32)
            tx[:r.tgt_x.shape[0]] = r.tgt_x
            txs.append(tx)
        pad_rows = batch_b - take
        if pad_rows:
            ks.extend([torch.zeros_like(ks[0])] * pad_rows)
            vs.extend([torch.zeros_like(vs[0])] * pad_rows)
            lens.extend([0] * pad_rows)
            txs.extend([np.zeros_like(txs[0])] * pad_rows)
        preds = _decode_batch(
            self.params, self.gcfg, self.num_options,
            torch.stack(ks), torch.stack(vs),
            self._tensor(np.asarray(lens, np.int64)),
            self._tensor(np.stack(txs)))
        preds = preds.cpu().numpy()  # waits for the device

        finished = self.now()
        batch_index = len(self.batches)
        self.batches.append(BatchRecord(
            rids=tuple(r.rid for r in reqs), batch_pad=batch_b,
            ctx_bucket=ctx_b, tgt_bucket=tgt_b, hits=tuple(hits)))
        out = []
        for i, r in enumerate(reqs):
            rows = r.tgt_x.shape[0] // self.num_options
            out.append(Completed(
                rid=r.rid, pred=preds[i, :rows], cache_hit=hits[i],
                arrival=r.arrival, finished=finished,
                batch_index=batch_index))
            self.stats.completed += 1
        return out

    # -- open-loop trace driver ----------------------------------------
    def run_trace(self, requests: Sequence[Request],
                  *, reset: bool = True,
                  clear_cache: bool = False) -> List[Completed]:
        """Drive a full arrival trace: requests are admitted when the
        engine clock passes their ``arrival`` (open loop), and the engine
        steps whenever work is queued. Returns completions in retirement
        order; rejected rids are in ``stats.rejected``."""
        if reset:
            self.reset(clear_cache=clear_cache)
        trace = sorted(requests, key=lambda r: r.arrival)
        results: List[Completed] = []
        i = 0
        while i < len(trace) or self._queue:
            now = self.now()
            while i < len(trace) and trace[i].arrival <= now:
                self.submit(trace[i])
                i += 1
            if not self._queue:
                if i >= len(trace):
                    break
                time.sleep(min(5e-4, max(0.0, trace[i].arrival - now)))
                continue
            results.extend(self.step())
        return results


# ---------------------------------------------------------------------------
# synthetic load generation + latency summaries
# ---------------------------------------------------------------------------
def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def make_request_trace(data, groups, *, num_requests: int,
                       hit_ratio: float = 0.0,
                       num_context: Tuple[int, int] = (6, 16),
                       num_target: Tuple[int, int] = (2, 8),
                       rate: Optional[float] = None,
                       seed: int = 0) -> List[Request]:
    """Build a request trace against a ``SurveyData`` population.

    ``hit_ratio`` controls prefix-cache pressure: the trace draws
    ``ceil((1 - hit_ratio) * N)`` unique (group, context) prefixes and
    spreads the remaining requests across them. ``num_context`` /
    ``num_target`` are inclusive ranges of QUESTIONS (points are
    questions x num_options). ``rate`` (requests/sec) spaces arrivals
    uniformly; None means all arrive at t=0 (saturation). numpy's
    generator: the same data arrays give the JAX package's trace."""
    rng = np.random.default_rng(seed)
    phi = _numpy(data.phi)
    prefs = _numpy(data.prefs)
    mask = _numpy(data.mask)
    d = phi.shape[-1]

    n_unique = max(1, int(np.ceil((1.0 - hit_ratio) * num_requests)))
    prefixes = []
    for u in range(n_unique):
        g = int(groups[rng.integers(len(groups))])
        answered = np.flatnonzero(mask[g])
        m = int(rng.integers(num_context[0], num_context[1] + 1))
        m = min(m, max(1, len(answered) - num_target[1]))
        ctx_q = rng.choice(answered, size=m, replace=False)
        ctx_x = phi[ctx_q].reshape(-1, d)
        ctx_y = prefs[g, ctx_q].reshape(-1)
        rest = np.setdiff1d(answered, ctx_q)
        prefixes.append((g, ctx_x, ctx_y, rest, u))

    assign = np.concatenate([
        np.arange(n_unique),
        rng.integers(0, n_unique, size=num_requests - n_unique)])
    rng.shuffle(assign)
    out = []
    for rid in range(num_requests):
        g, ctx_x, ctx_y, rest, u = prefixes[int(assign[rid])]
        t = int(rng.integers(num_target[0], num_target[1] + 1))
        tgt_q = rng.choice(rest, size=min(t, len(rest)), replace=False)
        tgt_x = phi[tgt_q].reshape(-1, d)
        arrival = 0.0 if rate is None else rid / rate
        out.append(Request(
            rid=rid, ctx_x=ctx_x.astype(np.float32),
            ctx_y=ctx_y.astype(np.float32),
            tgt_x=tgt_x.astype(np.float32),
            prefix_key=("ctx", g, u), arrival=arrival,
            meta={"group": g, "tgt_q": tgt_q}))
    return out


def latency_summary(results: Sequence[Completed],
                    wall_seconds: float) -> dict:
    """p50/p99 latency (ms) + throughput over a completed trace."""
    if not results:
        return {"completed": 0}
    lat = np.asarray([r.latency for r in results]) * 1e3
    return {
        "completed": len(results),
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_ms": float(lat.mean()),
        "max_ms": float(lat.max()),
        "qps": float(len(results) / max(wall_seconds, 1e-9)),
        "hit_rate": float(np.mean([r.cache_hit for r in results])),
    }
