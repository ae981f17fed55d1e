"""Serving launcher: ``python -m repro_torch.launch.serve --arch capsim``.

Port of ``repro/launch/serve.py``.  ``--arch capsim`` (the default) runs
``SimulationEngine`` over the first ``--n-benchmarks`` programs of the
synthetic suite (Table II) at the paper model's full width, with seeded
random parameters, and prints per-benchmark predictions, clip throughput
and the RT-cache build; ``--multicore N`` serves the multi-threaded
variants of the suite at N cores each (per-core and summed predictions),
and ``--rt-store-dir DIR`` loads the RT table from a persistent store
there, and persists it after the run.  ``--subsample FRACTION`` predicts
only a stratified sample of each benchmark's clips and prints each total
with its 95% bootstrap CI.  ``--mesh N`` shards every predict dispatch and
RT-cache encode pass over an N-shard data mesh: N cards with ``--device
cuda``, N shards on the CPU with ``--device cpu``; only ``--arch capsim``
takes it.  ``--engine-config`` takes an ``EngineConfig`` as a JSON object
or a path to one; the flags override its fields.  ``--service`` serves
the suite's clips as requests through the fault-tolerant
``SimulationService`` (deadlines, watchdog, degradation ladder;
``--faults`` injects chaos on the real path).  ``--metrics-port`` serves Prometheus text at ``/metrics``,
``--trace-out`` writes a Chrome/Perfetto trace and ``--flight-dir`` keeps
the service's demotion postmortems.  ``--arch mamba2-780m``, the dense
decoders (``olmo-1b``, ``qwen3-4b``, ``internlm2-20b``,
``nemotron-4-15b``) and the MoE and hybrid models (``kimi-k2-1t-a32b``,
``llama4-maverick-400b-a17b``, ``jamba-1.5-large-398b``) and the
frontend and codebook models (``qwen2-vl-2b``, ``musicgen-large``) run
the LM zoo's prefill + greedy decode loop (``generate``) on the smoke
config, as the reference does.  ``--device``
defaults to ``cuda``; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch


def parse_faults(spec):
    """``kind=rate,kind=rate`` -> dict for ``EngineConfig.faults``
    (validated there against the known chaos kinds)."""
    faults = {}
    for part in filter(None, (spec or "").split(",")):
        kind, _, rate = part.partition("=")
        faults[kind.strip()] = float(rate)
    return faults


def _build_engine_config(args):
    """``--engine-config`` (a JSON object, or a path to one) with the
    flags' fields over it, as one ``EngineConfig``."""
    from repro_torch.core.engine_config import (EngineConfig,
                                                ObservabilityConfig,
                                                SamplingConfig)
    if args.engine_config:
        text = args.engine_config
        if not text.lstrip().startswith("{"):
            with open(text) as fh:
                text = fh.read()
        config = EngineConfig.from_json(text)
    else:
        config = EngineConfig()
    kw = dict(
        interval_size=args.interval_size, warmup=0, max_checkpoints=1,
        l_min=100, batch_size=args.batch_size, with_oracle=False,
        rt_cache=not args.no_rt_cache, precision=args.precision,
        multicore=args.multicore, fused_serving=args.fused_serving)
    if args.rt_store_dir:
        kw["rt_store_dir"] = args.rt_store_dir
    if args.mesh:
        kw["mesh_shape"] = (args.mesh,)
    if args.faults:
        kw["faults"] = parse_faults(args.faults)
        kw["fault_seed"] = args.fault_seed
    if args.subsample is not None:
        kw["sampling"] = SamplingConfig(
            fraction=args.subsample, strata=args.strata,
            seed=args.sample_seed,
            min_clips_per_stratum=args.min_clips_per_stratum,
            bootstrap_resamples=args.bootstrap_resamples)
    if args.trace_out or args.flight_dir:
        kw["observability"] = ObservabilityConfig(
            trace=bool(args.trace_out), flight_dir=args.flight_dir)
    return config.replace(**kw)


def _start_metrics(args):
    """Start the /metrics exporter when --metrics-port is given.
    Returns the server (or None); the caller shuts it down."""
    if args.metrics_port is None:
        return None
    from repro_torch.obs.exporter import serve_metrics
    server = serve_metrics(port=args.metrics_port)
    print(f"metrics: http://{server.server_address[0]}:"
          f"{server.server_address[1]}/metrics")
    return server


def _dump_trace(args, obs) -> None:
    """Write the Chrome/Perfetto trace when --trace-out is given."""
    if args.trace_out and obs.tracer.enabled:
        obs.tracer.dump(args.trace_out)
        print(f"trace: {args.trace_out} "
              f"({len(obs.tracer.spans())} spans; open at ui.perfetto.dev)")


def serve_capsim(args) -> None:
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine import SimulationEngine
    from repro_torch.device import resolve_device
    from repro_torch.isa import multicore, progen

    device = resolve_device(args.device)
    engine_config = _build_engine_config(args)
    vocab = std_mod.build_vocab()
    cfg = config().replace(dtype="float32")
    params = predictor.init_params(cfg, seed=0, device=device)
    engine = SimulationEngine.from_config(params, cfg, vocab, engine_config,
                                          device=device)
    metrics_server = _start_metrics(args)
    if args.multicore > 0:
        # (benchmark, core) shards through the same pooled predictor;
        # per-core results demuxed, per-benchmark summed
        mbenches = multicore.all_multicore_benchmarks(args.multicore)
        t0 = time.time()
        mresults = engine.run_multicore(mbenches)
        wall = time.time() - t0
        for mr in mresults:
            line = (f"  {mr.name:16s} x{mr.n_cores} cores "
                    f"clips={mr.n_clips:5d} "
                    f"predicted={mr.predicted_cycles:12.0f} core-cycles")
            if mr.cycles_ci is not None:
                lo, hi = mr.cycles_ci
                line += f"  [{lo:.0f}, {hi:.0f}] 95% CI"
            print(line)
            for cr in mr.cores:
                print(f"    {cr.name:16s} clips={cr.n_clips:5d} "
                      f"predicted={cr.predicted_cycles:12.0f} cycles")
        served = (f"{len(mresults)} benchmarks x {args.multicore} cores "
                  f"({sum(mr.n_cores for mr in mresults)} core shards)")
    else:
        engine.submit_names(list(progen.TABLE_II)[: args.n_benchmarks])
        t0 = time.time()
        results = engine.run()
        wall = time.time() - t0
        for r in results:
            line = (f"  {r.name:16s} clips={r.n_clips:5d} "
                    f"predicted={r.predicted_cycles:12.0f} cycles")
            if r.cycles_ci is not None:
                lo, hi = r.cycles_ci
                line += (f"  [{lo:.0f}, {hi:.0f}] 95% CI "
                         f"({r.clips_predicted} predicted + "
                         f"{r.clips_extrapolated} extrapolated)")
            print(line)
        served = f"{len(results)} benchmarks"
    stats = engine.last_stats
    if engine.mesh is not None:
        served += f" over a {engine.mesh.n_shards}-shard mesh"
    print(f"served {served} on {device} "
          f"({stats.n_clips} clips, {stats.n_batches} device batches, "
          f"{stats.n_pad} pad rows) in {wall:.1f}s "
          f"= {stats.n_clips / max(wall, 1e-9):.0f} clips/s")
    rt = engine.last_rt_stats
    if rt is not None:
        print(f"rt-cache: {rt.n_rows_encoded} static rows encoded in "
              f"{rt.build_seconds:.2f}s served {rt.n_rows_served} dynamic "
              f"rows ({rt.rows_avoided} instruction-encoder rows avoided)")
        if rt.n_rows_loaded:
            print(f"rt-store: {rt.n_rows_loaded} rows loaded in "
                  f"{rt.store_load_seconds:.2f}s (cold encode skipped)")
    _dump_trace(args, engine.obs)
    if metrics_server is not None:
        metrics_server.shutdown()


def serve_service(args) -> None:
    """Run the fault-tolerant ``SimulationService`` over the synthetic
    suite: the clips of the first ``--n-benchmarks`` programs split into
    ``--n-requests`` requests with per-request deadlines; admission may
    shed (typed ``overloaded``), and ``--faults`` exercises the
    degradation ladder on live traffic."""
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.data.dataset import BuildConfig, build_dataset
    from repro_torch.device import resolve_device
    from repro_torch.isa import progen
    from repro_torch.serving.engine import Request
    from repro_torch.serving.service import ServiceSLA, SimulationService

    device = resolve_device(args.device)
    # the service owns precision/fusion (the degradation ladder): the
    # base config only contributes the structural axes
    engine_config = _build_engine_config(args).replace(
        precision=None, fused_serving=False)
    vocab = std_mod.build_vocab()
    cfg = config().replace(dtype="float32")
    params = predictor.init_params(cfg, seed=0, device=device)

    names = list(progen.TABLE_II)[: args.n_benchmarks]
    bcfg = BuildConfig(interval_size=engine_config.interval_size, warmup=0,
                       max_checkpoints=1, l_min=100,
                       l_clip=engine_config.l_clip,
                       l_token=engine_config.l_token)
    ds = build_dataset(names, bcfg, vocab)
    sla = ServiceSLA(default_deadline_s=args.deadline_s,
                     watchdog_s=args.watchdog_s)

    metrics_server = _start_metrics(args)
    t0 = time.time()
    with SimulationService(params, cfg, engine_config, sla=sla,
                           device=device) as svc:
        tickets = []
        per_req = max(1, len(ds) // max(args.n_requests, 1))
        for i in range(args.n_requests):
            lo = (i * per_req) % len(ds)
            hi = min(lo + per_req, len(ds))
            tickets.append(svc.submit(Request(
                i, ds.clip_tokens[lo:hi], ds.context_tokens[lo:hi],
                ds.clip_mask[lo:hi])))
        results = [t.result(timeout=600) for t in tickets]
        stats = svc.stats()
    wall = time.time() - t0

    for r in results:
        extra = f" [{r.error}]" if r.error else ""
        print(f"  req {r.request_id:3d} {r.status:17s} "
              f"tier={r.tier or '-':10s} clips={r.n_clips:5d} "
              f"latency={r.latency_seconds:6.2f}s{extra}")
    n_clips = sum(r.n_clips for r in results if r.ok)
    print(f"service on {device}: {stats['statuses']} "
          f"tier={stats['current_tier']} in {wall:.1f}s = "
          f"{n_clips / max(wall, 1e-9):.0f} clips/s")
    if stats["faults_fired"]:
        print(f"faults fired: {stats['faults_fired']}")
    for name, ts in stats["tiers"].items():
        hits = {k: v for k, v in ts.items() if v and k != "name"}
        if hits:
            print(f"  tier {name}: {hits}")
    _dump_trace(args, svc.obs)
    if svc.obs.flight is not None and svc.obs.flight.postmortems:
        print(f"postmortems: {len(svc.obs.flight.postmortems)} written "
              f"to {args.flight_dir}")
    if metrics_server is not None:
        metrics_server.shutdown()


@dataclasses.dataclass
class Generation:
    """What ``generate`` returns.  tokens: (B, 1 + decode_steps[, C])
    greedy ids, the prefill's then each decode step's (per codebook with
    C > 1 codebooks); logits: (B, 1 + decode_steps[, C], V_pad) the last
    position's logits at each step; prefill_seconds: prefill and its
    argmax; decode_seconds: all decode steps (host clock, synchronized on
    a card)."""
    tokens: torch.Tensor
    logits: torch.Tensor
    prefill_seconds: float
    decode_seconds: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_rows(batch: dict, lay) -> dict:
    """The rank's rows of a prefill batch under ``lay``: its block of the
    batch and of the sequence (M-RoPE's (3, B, S) positions carry the
    batch second)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import current_mesh
    mesh = current_mesh()
    out = {}
    for k, v in batch.items():
        b = 1 if k == "positions" and v.dim() == 3 else 0
        v = coll.take_block(v, mesh, lay.batch, b)
        out[k] = v if k == "frontend" else coll.take_block(
            v, mesh, lay.seq, b + 1)
    return out


@torch.no_grad()
def generate(params: dict, cfg, batch: dict, decode_steps: int,
             device="cuda") -> Generation:
    """Prefill ``batch`` ('tokens' (B, S[, C]), and the optional
    'frontend' and 'positions' that ``transformer.forward`` takes), then
    ``decode_steps`` greedy decode steps against the prefill's caches
    (the reference's ``serve_lm`` loop).  The prefill covers S_total =
    F + S positions with F frontend embeddings, and decode step i runs at
    ``cache_pos`` S_total + i.  With codebooks the next token is each
    codebook's argmax, (B, 1, C).  Attention caches are first placed into
    decode caches of ``S_total + decode_steps`` positions; an SSM cache
    does not grow with the sequence and is used as it is (a hybrid holds
    both).  An MoE layer's capacity counts the tokens of each call: the
    prefill's B·S_total, then each decode step's B.

    Under a mesh and rules (any of the seven tables, the parameters
    whole or the rank's blocks) the rank prefills its rows
    (``sharding.layout``), places the caches into the decode layout
    (``transformer.place_caches``) and decodes its batch rows; the last
    position's logits are gathered across the vocab blocks, so the
    argmax crosses them and breaks ties to the lower global index, as
    ``jnp.argmax``; the returned tokens and logits are gathered whole."""
    from repro_torch.device import resolve_device
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tfm

    dev = resolve_device(device)
    batch = {k: v.to(dev) for k, v in batch.items()}
    mesh = sh.current_mesh()
    B, S = batch["tokens"].shape[:2]
    if cfg.frontend != "none" and "frontend" in batch:
        S += batch["frontend"].shape[1]
    pre = sh.layout(B, S)
    dec = sh.layout(B, 1, S + decode_steps)
    vocab, _ = tfm.vocab_block(cfg)

    def last_logits(logits, seq=()):
        last = logits[:, -1:]
        if seq:
            last = coll.all_gather(last, mesh, seq, 1)[:, -1:]
        return coll.all_gather(last[:, 0], mesh, vocab, last.dim() - 2)

    t0 = time.perf_counter()
    with sh.use_layout(pre):
        logits, caches = tfm.prefill_step(params, _rank_rows(batch, pre),
                                          cfg)
    last = [last_logits(logits, pre.seq).clone()]   # frees the logits
    del logits
    caches = tfm.place_caches(cfg, caches, S + decode_steps, pre, dec)
    out = [last[-1].argmax(-1)]
    _sync(dev)
    t1 = time.perf_counter()
    with sh.use_layout(dec):
        for i in range(decode_steps):
            logits, caches = tfm.decode_step(
                params, {"tokens": out[-1][:, None]}, cfg, caches, S + i)
            last.append(last_logits(logits))
            out.append(last[-1].argmax(-1))
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(coll.all_gather(torch.stack(out, 1), mesh, dec.batch,
                                      0),
                      coll.all_gather(torch.stack(last, 1), mesh, dec.batch,
                                      0), t1 - t0, t2 - t1)


def serve_lm(args) -> None:
    """The LM zoo's smoke config: a prefill of B=2 x 32 tokens and greedy
    decode steps, under the reference's ``make_test_mesh()`` and
    ``LOGICAL_RULES_DECODE`` (one device: the MoE layers take the
    expert-parallel path over one shard, the attention its one-shard
    fallbacks, with the tokens of the meshless path)."""
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import (LOGICAL_RULES_DECODE,
                                                  use_mesh_and_rules)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    B, S = 2, 64
    with use_mesh_and_rules(make_test_mesh(device), LOGICAL_RULES_DECODE):
        params = tfm.init_params(cfg, seed=0, device=device)
        batch = random_batch(cfg, ShapeConfig("p", S // 2, B, "prefill"),
                             "prefill", device=device)
        gen = generate(params, cfg, batch, args.decode_steps, device)
    what = []
    if "frontend" in batch:
        what.append(f"the first {batch['frontend'].shape[1]} frontend "
                    "embeddings")
    if cfg.num_codebooks > 1:
        what.append(f"{cfg.num_codebooks} codebooks a token")
    print(f"{args.arch}: prefill {S // 2} tokens"
          + (f" ({', '.join(what)})" if what else "")
          + f" in {gen.prefill_seconds:.3f}s + {args.decode_steps} decode "
          f"steps in {gen.decode_seconds:.3f}s on {device}; tokens "
          f"{gen.tokens.tolist()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="capsim",
                    help="capsim (the engine), or mamba2-780m, olmo-1b, "
                         "qwen3-4b, internlm2-20b, nemotron-4-15b, "
                         "kimi-k2-1t-a32b, llama4-maverick-400b-a17b, "
                         "jamba-1.5-large-398b, qwen2-vl-2b or "
                         "musicgen-large (LM prefill + greedy decode on "
                         "the smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--interval-size", type=int, default=10_000)
    ap.add_argument("--n-benchmarks", type=int, default=4)
    ap.add_argument("--multicore", type=int, default=0, metavar="N_CORES",
                    help="serve the multi-threaded benchmark variants at "
                         "N cores per benchmark (0 = single-core suite)")
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--no-rt-cache", action="store_true",
                    help="monolithic predict path (re-encode every "
                         "dynamic instruction row)")
    ap.add_argument("--precision", default=None,
                    choices=("fp32", "bf16", "int8"),
                    help="inference numerics; default keeps the config "
                         "dtype (fp32 here)")
    ap.add_argument("--fused-serving", action="store_true",
                    help="dedup-fused block-encoder serving step "
                         "(weighted attention over each clip's unique "
                         "context tokens + precomputed cross K/V)")
    ap.add_argument("--rt-store-dir", default=None, metavar="DIR",
                    help="persistent content-addressed RT-cache store: "
                         "load-or-rebuild the (row -> RT vector) table "
                         "keyed on (params, config, vocab, framework and "
                         "device), persisted after each run")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard inference over an N-shard data mesh "
                         "(predict dispatch + RT-cache encode passes; "
                         "equal to unsharded): N cards on cuda, N "
                         "shards on the CPU with --device cpu.  0 = no "
                         "mesh")
    ap.add_argument("--engine-config", default=None, metavar="JSON",
                    help="EngineConfig as a JSON object or a path to a "
                         "JSON file; individual flags override its "
                         "fields")
    ap.add_argument("--subsample", type=float, default=None,
                    metavar="FRACTION",
                    help="analytical-ML fusion: predict only a "
                         "stratified FRACTION of each benchmark's clips "
                         "and extrapolate the rest from analytical "
                         "features with a bootstrap CI (default: full "
                         "prediction)")
    ap.add_argument("--strata", type=int, default=4,
                    help="--subsample: quantile strata over the "
                         "analytical cycle estimate")
    ap.add_argument("--min-clips-per-stratum", type=int, default=2,
                    help="--subsample: floor of sampled clips per "
                         "non-empty stratum")
    ap.add_argument("--bootstrap-resamples", type=int, default=200,
                    help="--subsample: bootstrap resamples behind the "
                         "95%% CI (0 disables)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="--subsample: sampling + bootstrap seed")
    ap.add_argument("--service", action="store_true",
                    help="serve through the fault-tolerant "
                         "SimulationService (bounded queue, deadlines, "
                         "watchdog, graceful degradation) instead of the "
                         "batch SimulationEngine")
    ap.add_argument("--n-requests", type=int, default=8,
                    help="--service: number of requests to split the "
                         "suite's clips across")
    ap.add_argument("--deadline-s", type=float, default=120.0,
                    help="--service: per-request deadline (SLA)")
    ap.add_argument("--watchdog-s", type=float, default=60.0,
                    help="--service: abort any single flush after this "
                         "many seconds and retry a tier down")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve Prometheus text at "
                         "http://127.0.0.1:PORT/metrics for the run's "
                         "duration (0 = ephemeral port, printed)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome/"
                         "Perfetto trace-event JSON at exit (open at "
                         "ui.perfetto.dev)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="enable the degradation flight recorder: every "
                         "service demotion dumps a postmortem JSON "
                         "(events + recent spans + metrics) into DIR")
    ap.add_argument("--faults", default=None, metavar="KIND=RATE,...",
                    help="chaos injection on the real serving path, e.g. "
                         "'nan_output=0.1,device_error=0.05' (kinds: "
                         "device_error nan_output slow_flush "
                         "corrupt_rt_read crash_persist)")
    ap.add_argument("--fault-seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.arch != "capsim" and (args.mesh or args.engine_config):
        ap.error(f"--mesh and --engine-config are the CAPSim engine's; "
                 f"--arch {args.arch} builds no mesh")
    if args.arch == "capsim" and args.service:
        serve_service(args)
    elif args.arch == "capsim":
        serve_capsim(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
