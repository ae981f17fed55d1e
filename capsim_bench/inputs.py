"""The cells' inputs, made by the frozen front-end (``frontend/``) and
kept in a cache of the checkout keyed by their parameters, never by the
seed: the seed picks the weights and the order of the inputs, not the
inputs themselves.

``request_pool``: one request per checkpoint interval of each program,
tokenized as the simulation engine tokenizes an interval (fixed clips of
``l_min`` instructions padded to ``l_clip``, the context snapshot at each
clip's start).  ``train_set``: the labelled clip dataset the trainer
reads, single-core (``dataset.build_dataset``) or multicore with peer
channels (``multicore_dataset.build_multicore_dataset``).
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict

import numpy as np

from capsim_bench.frontend import context as ctx_mod
from capsim_bench.frontend import funcsim, progen
from capsim_bench.frontend import standardize as std_mod


def _key(kind: str, params: dict) -> str:
    blob = json.dumps({"kind": kind, **params}, sort_keys=True)
    return f"{kind}-{hashlib.sha256(blob.encode()).hexdigest()[:16]}"


def _cached(cache: Path, kind: str, params: dict, make) -> Dict[str, np.ndarray]:
    """``make()``'s arrays, from the cache when an earlier run made them.
    Written to a temporary name and renamed, so a cut run leaves no
    half-written file behind."""
    path = cache / f"{_key(kind, params)}.npz"
    if path.exists():
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    arrays = make()
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays


def _programs(spec) -> list:
    """A traffic file's program list: names, or "table2" / "multicore"
    for the whole suite."""
    if spec == "table2":
        return list(progen.TABLE_II)
    if spec == "multicore":
        from capsim_bench.frontend.multicore import MULTICORE_NAMES
        return list(MULTICORE_NAMES)
    return list(spec)


def request_pool(t: dict, c: dict, cache: Path) -> Dict[str, np.ndarray]:
    """Every interval of the mix as one request: ``clip_tokens`` (N,
    l_clip, l_token) int16, ``context_tokens`` (N, M) int16, ``clip_mask``
    (N, l_clip) uint8, and ``offsets`` (R + 1,) into the N clips."""
    params = {"programs": _programs(t["programs"]),
              "interval": t["interval"], "warmup": t["warmup"],
              "checkpoints": t["checkpoints"], "l_min": t["l_min"],
              "l_clip": c["clip_len"], "l_token": c["clip_tokens"]}

    def make():
        vocab = std_mod.build_vocab()
        toks, ctxs, masks, offsets = [], [], [], [0]
        for name in params["programs"]:
            bench = progen.build_benchmark(name)
            cprog = bench.compiled()
            table = cprog.token_table(vocab, params["l_token"])
            st = progen.fresh_compiled_state(bench)
            _, st = funcsim.run_compiled(cprog, params["warmup"], st)
            for _ in range(min(bench.ckp_num, params["checkpoints"])):
                trace, st = funcsim.run_compiled(
                    cprog, params["interval"], st,
                    snapshot_every=params["l_min"])
                if not len(trace):
                    break
                tok, mask = std_mod.encode_fixed_clips(
                    table, trace.pc, params["l_min"], params["l_clip"])
                ctx_all = ctx_mod.context_tokens_from_matrix(
                    trace.snapshots, vocab)
                rows = np.minimum(np.arange(tok.shape[0]), len(ctx_all) - 1)
                toks.append(tok.astype(np.int16))
                ctxs.append(ctx_all[rows].astype(np.int16))
                masks.append(mask.astype(np.uint8))
                offsets.append(offsets[-1] + tok.shape[0])
        return {"clip_tokens": np.concatenate(toks),
                "context_tokens": np.concatenate(ctxs),
                "clip_mask": np.concatenate(masks),
                "offsets": np.asarray(offsets, np.int64)}
    return _cached(cache, "pool", params, make)


def train_set(t: dict, c: dict, cache: Path) -> Dict[str, np.ndarray]:
    """The labelled clips of the mix's programs (``time``: the oracle's
    cycles), in the builders' order."""
    params = {"programs": _programs(t["programs"]),
              "interval": t["interval"], "warmup": t["warmup"],
              "checkpoints": t["checkpoints"], "l_clip": c["clip_len"],
              "l_token": c["clip_tokens"], "n_cores": c["n_cores"],
              "peer_channels": c["peer_channels"]}

    def make():
        from capsim_bench.frontend import dataset
        vocab = std_mod.build_vocab()
        common = dict(interval_size=params["interval"],
                      warmup=params["warmup"],
                      max_checkpoints=params["checkpoints"],
                      l_clip=params["l_clip"], l_token=params["l_token"])
        if params["n_cores"] > 1:
            from capsim_bench.frontend import multicore_dataset as mcd
            ds = mcd.build_multicore_dataset(
                params["programs"], mcd.MulticoreBuildConfig(
                    n_cores=params["n_cores"],
                    peer_channels=params["peer_channels"], **common), vocab)
        else:
            ds = dataset.build_dataset(params["programs"],
                                       dataset.BuildConfig(**common), vocab)
        return {"clip_tokens": ds.clip_tokens.astype(np.int16),
                "context_tokens": ds.context_tokens.astype(np.int16),
                "clip_mask": ds.clip_mask.astype(np.uint8),
                "time": ds.time}
    return _cached(cache, "train", params, make)
