"""Static-instruction RT cache: the two-level inference split (port of
``repro/core/rt_cache.py``).

An instruction's RT vector (paper Eq 5-8) depends only on its static
standardized tokens, so each program's ``n_static`` unique token rows go
through the 4-layer instruction encoder once (``build``) and every clip
batch becomes an ``rt_table[rt_idx]`` gather (``serve``).  The cache is
content-addressed by row bytes, so rows dedupe across programs; row id 0
is the all-<PAD> row that masked clip slots gather.

The table is one preallocated device tensor that ``_flush`` writes in
place (the reference rebuilds an immutable array on every ``.at[].set``).
Identity therefore says nothing about content here: ``version`` counts
the writes, and anything derived from the table (the fused step's serving
plan) keys on it.  In-place writes only fill rows no batch has gathered
yet, and run in stream order after every batch dispatched before them.

Persistence (``store_dir``), as the reference's: the (row bytes -> RT
vector) table is checkpointed through ``checkpoint/ckpt.py`` under a
content key hashing the parameter bytes (on the host: bfloat16 by its raw
bits, int8 fake-quantized weights as stored), the model config, l_token
and ``extra``: the vocab signature, and after it the framework and device
(``store_tag``: ``repro_torch/cpu`` or ``repro_torch/cuda/<card name>``).
So a store the JAX package wrote is never adopted, nor one encoded on the
CPU by the card or the reverse (the two differ by ~2e-7): equal keys mean
bitwise-equal tables, as in the reference, within one framework and
device.  A fresh cache with a matching key adopts the stored table byte
for byte instead of re-encoding; any key component changing lands on
another store path; a corrupt or truncated store warns and falls back to
the cold encode.  The serving layer's fault injector, where one is given,
corrupts a store read inside the load's ``try`` (``corrupt_rt_read``: warn
and cold-encode) and crashes a persist at ``ckpt.save``'s ``pre_publish``,
after the files are written and before the atomic publish
(``crash_persist``: the previous generation stays the store's).

Threads.  The serving layer runs flushes on worker threads, and a flush
its watchdog abandoned may still run beside the retry on a sibling rung
that shares this cache.  ``ensure_rows``, ``persist`` and the store load
hold one lock, so two threads never hand out the same row id or persist
a half-grown table.  The ids a caller holds are all below the row count
it saw, and those rows are never written again: a reader gathers from the
table it read from ``table``, a newer tensor holds every older row, and
the write and the gather are ordered on the one CUDA stream both use.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import predictor as pred_mod
from repro_torch.core.standardize import dedupe_token_rows
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import SPAN_SECONDS_TOTAL, Observability

PAD_ROW_ID = 0

# Bump when the persisted layout/semantics change: old stores then fail
# the metadata check and rebuild cold instead of being misread.
RT_STORE_VERSION = 1


def store_tag(device: DeviceLike) -> str:
    """The framework and device a table was encoded with, for the store
    key: tables encoded on the CPU and on a card differ in the last bits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"repro_torch/cuda/{torch.cuda.get_device_name(dev)}"
    return "repro_torch/cpu"


def rt_store_key(params, cfg, l_token: Optional[int] = None,
                 extra: str = "") -> str:
    """Content key for the persistent RT store: a hash over the exact
    parameter bytes, the model config repr, the token-row width, and
    ``extra`` (the vocab signature and ``store_tag`` by convention).
    Equal keys => bitwise-equal tables."""
    h = hashlib.sha256()
    flat = ckpt._flatten(params)
    for key in sorted(flat):
        t = flat[key].detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)         # the raw bits
        h.update(key.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(flat[key].dtype).encode())
        h.update(t.numpy().tobytes())
    h.update(repr(cfg).encode())
    h.update(str(l_token).encode())
    h.update(extra.encode())
    return h.hexdigest()[:32]

# Every encode pass runs at least this many rows (the reference's XLA-CPU
# row-stability class).  The port keeps the bucket ladder so an encode
# pass sees the same shapes as the reference's.
ENCODE_STABLE_MIN = 32


def encode_bucket(n: int) -> int:
    """Pad target for an encode pass: next power of two >=
    max(n, ENCODE_STABLE_MIN), bounding pass shapes to ~log2(n_static)."""
    b = ENCODE_STABLE_MIN
    while b < n:
        b *= 2
    return b


class _RowsAvoidedMixin:
    @property
    def rows_avoided(self) -> int:
        """Dynamic instruction-encoder rows the gather replaced."""
        return max(self.n_rows_served - self.n_rows_encoded, 0)


@dataclasses.dataclass(frozen=True)
class RTCacheStatsSnapshot(_RowsAvoidedMixin):
    """Point-in-time copy of an :class:`RTCacheStats` view."""

    n_rows_encoded: int = 0
    n_encode_passes: int = 0
    n_rows_served: int = 0
    n_lookups: int = 0
    build_seconds: float = 0.0
    n_rows_loaded: int = 0
    store_load_seconds: float = 0.0


class RTCacheStats(_RowsAvoidedMixin):
    """Live view over the obs metrics registry for one cache instance;
    with no arguments an all-zeros stand-in."""

    def __init__(self, obs: Optional[Observability] = None,
                 instance: str = ""):
        self._obs = obs
        self._instance = instance

    def _val(self, name: str) -> float:
        if self._obs is None:
            return 0.0
        return self._obs.metrics.value(name, instance=self._instance)

    @property
    def n_rows_encoded(self) -> int:
        return int(self._val("capsim_rt_rows_encoded_total"))

    @property
    def n_encode_passes(self) -> int:
        return int(self._val("capsim_rt_encode_passes_total"))

    @property
    def n_rows_served(self) -> int:
        return int(self._val("capsim_rt_rows_served_total"))

    @property
    def n_lookups(self) -> int:
        return int(self._val("capsim_rt_lookups_total"))

    def _span_s(self, span: str) -> float:
        if self._obs is None:
            return 0.0
        return self._obs.metrics.value(SPAN_SECONDS_TOTAL, span=span,
                                       instance=self._instance)

    @property
    def build_seconds(self) -> float:
        return self._span_s("rt.build")

    @property
    def n_rows_loaded(self) -> int:
        return int(self._val("capsim_rt_rows_loaded"))

    @property
    def store_load_seconds(self) -> float:
        return self._span_s("rt.store_load")

    def freeze(self) -> RTCacheStatsSnapshot:
        return RTCacheStatsSnapshot(
            n_rows_encoded=self.n_rows_encoded,
            n_encode_passes=self.n_encode_passes,
            n_rows_served=self.n_rows_served,
            n_lookups=self.n_lookups,
            build_seconds=self.build_seconds,
            n_rows_loaded=self.n_rows_loaded,
            store_load_seconds=self.store_load_seconds)


class RTCache:
    """Content-addressed map from standardized token rows to rows of a
    device-resident RT table.

    ``ensure_rows`` returns global int32 row ids, encoding unseen rows in
    one bucketed pass; ``table`` is the (capacity, E) tensor
    ``forward_cached`` gathers from.  Capacity doubles when full (a new
    tensor); ``version`` increments on every write.  With ``store_dir``
    the cache first adopts the table persisted under its content key, if
    any, and ``persist`` writes it back.  ``fault_injector`` (a
    ``serving.faults.FaultInjector`` or None) may corrupt the store read
    and crash the persist on those real code paths.
    """

    def __init__(self, params, cfg, l_token: Optional[int] = None, *,
                 capacity: int = 4096, device: DeviceLike = "cuda",
                 store_dir: Optional[str] = None, store_extra: str = "",
                 fault_injector=None,
                 obs: Optional[Observability] = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.l_token = l_token
        self.obs = obs if obs is not None else Observability()
        m = self.obs.metrics
        self.instance = m.next_instance("rt")
        self._c_encoded = m.counter(
            "capsim_rt_rows_encoded_total",
            "Unique static rows run through the instruction encoder.",
            ("instance",)).labels(instance=self.instance)
        self._c_passes = m.counter(
            "capsim_rt_encode_passes_total",
            "Device encode passes (one per new-row flush).",
            ("instance",)).labels(instance=self.instance)
        self._c_served = m.counter(
            "capsim_rt_rows_served_total",
            "Dynamic (unmasked) rows answered by the RT gather.",
            ("instance",)).labels(instance=self.instance)
        self._c_lookups = m.counter(
            "capsim_rt_lookups_total",
            "Rows presented to ensure_rows.",
            ("instance",)).labels(instance=self.instance)
        self._g_loaded = m.gauge(
            "capsim_rt_rows_loaded",
            "Rows adopted from the persistent store (0 after a failed "
            "load).", ("instance",)).labels(instance=self.instance)
        self._faults = fault_injector
        self._lock = threading.RLock()
        self._index: Dict[bytes, int] = {}
        self._table: Optional[torch.Tensor] = None
        self._capacity = capacity
        self._n = 0
        self.version = 0
        self.stats = RTCacheStats(self.obs, self.instance)
        # persistent store: one ckpt directory per content key under
        # store_dir; loaded eagerly so a warm store never cold-encodes
        self._store_path: Optional[Path] = None
        self._persisted_rows = 0
        if store_dir is not None:
            self._store_key = rt_store_key(
                params, cfg, l_token,
                f"{store_extra}\n{store_tag(self.device)}")
            self._store_path = Path(store_dir) / self._store_key
            self._load_store()

    @property
    def n_rows(self) -> int:
        return self._n

    @property
    def table(self) -> torch.Tensor:
        if self._table is None:
            raise RuntimeError("RT cache is empty (no rows ensured)")
        return self._table

    def ensure_rows(self, rows: np.ndarray,
                    keys: Optional[Sequence[bytes]] = None) -> np.ndarray:
        """rows: (k, L_token) int32 standardized rows -> (k,) int32 global
        RT row ids; unseen rows are encoded in one padded pass.  ``keys``
        (the rows' ``tobytes()``) skips re-hashing."""
        with self._lock, self.obs.span("rt.build", instance=self.instance):
            rows = np.ascontiguousarray(rows, dtype=np.int32)
            if self.l_token is None:
                self.l_token = rows.shape[1]
            if rows.ndim != 2 or rows.shape[1] != self.l_token:
                raise ValueError(f"rows must be (k, {self.l_token}), got "
                                 f"{rows.shape}")
            if keys is None:
                keys = [r.tobytes() for r in rows]
            self._c_lookups.inc(rows.shape[0])

            new_rows: List[np.ndarray] = []
            pending: Dict[bytes, int] = {}
            if self._n == 0:                 # reserve the all-<PAD> row
                pad = np.zeros(self.l_token, np.int32)
                pending[pad.tobytes()] = PAD_ROW_ID
                new_rows.append(pad)
            ids = np.empty(rows.shape[0], np.int32)
            index = self._index
            for i, key in enumerate(keys):
                gid = index.get(key)
                if gid is None:
                    gid = pending.get(key)
                    if gid is None:
                        gid = self._n + len(new_rows)
                        pending[key] = gid
                        new_rows.append(rows[i])
                ids[i] = gid
            if new_rows:
                self._flush(np.stack(new_rows), pending)
        return ids

    def record_served(self, n: int) -> None:
        """Count dynamic rows the gather answered."""
        self._c_served.inc(n)

    def index_clips(self, clip_tokens: np.ndarray) -> np.ndarray:
        """Serving-path adapter: (n, L_clip, L_token) tokenized clips ->
        (n, L_clip) int32 RT row ids.  All-<PAD> slots land on row 0."""
        n, L, T = clip_tokens.shape
        uniq, inv = dedupe_token_rows(clip_tokens.reshape(n * L, T))
        ids = self.ensure_rows(uniq)
        return ids[inv].reshape(n, L).astype(np.int32)

    @torch.inference_mode()
    def _flush(self, rows: np.ndarray, pending: Dict[bytes, int]) -> None:
        # the table is written only here and at the store load, both in
        # inference mode, so it is one inference tensor whichever thread
        # (a service's flush thread or the caller's) grows it; every
        # other use of it only reads
        k = rows.shape[0]
        bucket = encode_bucket(k)
        if bucket != k:
            rows = np.concatenate(
                [rows, np.zeros((bucket - k, self.l_token), np.int32)])
        rt = pred_mod.encode_instructions(
            self.params, torch.as_tensor(rows, device=self.device),
            self.cfg)[:k]
        lo = self._n
        while lo + k > self._capacity:
            self._capacity *= 2
        if self._table is None or self._table.shape[0] < self._capacity:
            table = torch.zeros((self._capacity, rt.shape[1]),
                                dtype=rt.dtype, device=self.device)
            if self._table is not None and lo:
                table[:lo] = self._table[:lo]
            self._table = table
        self._table[lo:lo + k] = rt
        self.version += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # build time stays in stats
        self._index.update(pending)
        self._n += k
        self._c_encoded.inc(k)
        self._c_passes.inc()

    # ------------------------------------------------------------------ #
    # Persistent store
    # ------------------------------------------------------------------ #

    def _load_store(self) -> None:
        """Adopt the persisted (rows -> RT vectors) table if a store
        exists under this cache's content key.  Key/version mismatch is
        the expected invalidation path (silent clean rebuild); a store
        that matches the key but fails validation (truncated file, wrong
        shapes, non-finite values) warns and cold-encodes."""
        with self._lock, torch.inference_mode(), self.obs.span(
                "rt.store_load", instance=self.instance):
            self._load_store_inner(self._store_path)

    def _load_store_inner(self, path: Path) -> None:
        try:
            step = ckpt.latest_step(str(path))
            if step is None:
                return
            meta = ckpt.read_manifest(step, str(path)).get("metadata", {})
            if (meta.get("store_key") != self._store_key
                    or meta.get("version") != RT_STORE_VERSION):
                return                           # clean rebuild, no warn
            n, lt, e = (int(meta["n_rows"]), int(meta["l_token"]),
                        int(meta["d_model"]))
            if n < 1 or (self.l_token is not None and lt != self.l_token):
                return
            state = ckpt.restore({"rows": None, "table": None}, step,
                                 str(path), device="cpu")
            if self._faults is not None:
                # corrupt_rt_read chaos: a read that returned garbage;
                # raising inside this try runs the real warn + cold-encode
                # fallback below
                self._faults.maybe_raise(
                    "corrupt_rt_read", "injected corrupt RT-store read")
            rows = state["rows"].numpy()
            table = state["table"]
            if rows.shape != (n, lt) or tuple(table.shape) != (n, e):
                raise ValueError(
                    f"stored shapes {rows.shape}/{tuple(table.shape)} != "
                    f"manifest ({n}, {lt})/({n}, {e})")
            if rows.dtype != np.int32:
                raise ValueError(f"stored rows dtype {rows.dtype}")
            if table.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"stored table dtype {table.dtype}")
            if not bool(torch.isfinite(table).all()):
                raise ValueError("stored table has non-finite values")
            if rows[0].any():
                raise ValueError("stored pad row (id 0) is not all-<PAD>")
            keys = [r.tobytes() for r in rows]
            if len(set(keys)) != n:
                raise ValueError("stored rows are not unique")
            self.l_token = lt
            while self._capacity < n:
                self._capacity *= 2
            self._table = torch.zeros((self._capacity, e), dtype=table.dtype,
                                      device=self.device)
            self._table[:n] = table.to(self.device)
            self.version += 1
            self._index = {k: i for i, k in enumerate(keys)}
            self._n = n
            self._persisted_rows = n
            self._g_loaded.set(n)
        except Exception as exc:                     # noqa: BLE001
            warnings.warn(
                f"RT store at {path} unreadable ({exc!r}); "
                "falling back to cold encode", stacklevel=2)
            self._index = {}
            self._table = None
            self._n = 0
            self._persisted_rows = 0
            self._g_loaded.set(0)
            self.obs.event("rt_store_load_failure", path=str(path),
                           error=repr(exc))

    def persist(self) -> Optional[Path]:
        """Checkpoint the current table under the store key (atomic
        overwrite via ``ckpt.save``).  No-op without a store, on an empty
        cache, or when nothing grew since the last load/persist.  Rows
        are reconstructed from the index keys, so the persisted mapping
        is exactly what ``ensure_rows`` would serve."""
        with self._lock:
            return self._persist()

    def _persist(self) -> Optional[Path]:
        if (self._store_path is None or self._n == 0
                or self._n == self._persisted_rows):
            return None
        rows = np.zeros((self._n, self.l_token), np.int32)
        for key, gid in self._index.items():
            rows[gid] = np.frombuffer(key, np.int32)
        table = self._table[:self._n]
        meta = {"store_key": self._store_key,
                "version": RT_STORE_VERSION,
                "n_rows": int(self._n),
                "l_token": int(self.l_token),
                "d_model": int(table.shape[1])}
        out = ckpt.save({"rows": rows, "table": table}, 0,
                        str(self._store_path), metadata=meta,
                        pre_publish=(self._faults.crash_hook()
                                     if self._faults is not None
                                     else None))
        self._persisted_rows = self._n
        return out
