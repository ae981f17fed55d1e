"""NemotronH (nemotron-3-nano-30b-a3b) in the port against the plain
reference ``tests/nemotron_h_reference.py``, at smoke size on seeded
weights on the CPU: logits, loss and every gradient; prefill then decode
through the SSM states and the KV cache against the reference's full
forward; the grouped SSD scan (plain version, backward, decode step)
against a loop over its groups, with one group the same bits as B/C
shared by every head; the sigmoid router with its correction bias; and
the expert share, whose parts over the 8 shards, with the shared expert
once, add up to the uncut layer.  The benchmark's copy of the reference
is this one.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import nemotron_h_reference as ref  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCH = "nemotron-3-nano-30b-a3b"
ROOT = Path(__file__).resolve().parent.parent


def ref_config(cfg) -> dict:
    """The port's config under the published keys the reference reads."""
    return {"hidden_size": cfg.d_model,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "mamba_num_heads": cfg.ssm_num_heads,
            "mamba_head_dim": cfg.ssm_head_dim,
            "ssm_state_size": cfg.ssm_state, "n_groups": cfg.ssm_groups,
            "conv_kernel": cfg.ssm_conv_width, "chunk_size": cfg.ssm_chunk,
            "num_experts_per_tok": cfg.experts_per_token,
            "routed_scaling_factor": cfg.routed_scaling,
            "layer_norm_epsilon": cfg.norm_eps,
            "hybrid_override_pattern": cfg.layer_pattern,
            "num_hidden_layers": cfg.num_layers,
            "router_outputs": cfg.num_experts,
            "n_routed_experts": cfg.experts_held or cfg.num_experts,
            "expert_shard": cfg.expert_shard,
            "capacity_factor": cfg.capacity_factor,
            "vocab_size": cfg.vocab_size,
            "moe_intermediate_size": cfg.d_ff,
            "moe_shared_expert_intermediate_size": cfg.shared_expert_d_ff,
            "param_dtype": cfg.param_dtype,
            "use_conv_bias": cfg.ssm_conv_bias}


def _batch(cfg, B=2, S=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    return {"tokens": t[:, :-1], "labels": t[:, 1:],
            "loss_mask": torch.ones(B, S)}


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_config_is_the_published_model():
    cfg = get_config(ARCH)
    kinds = [cfg.mixer_at(i) if cfg.mixer_at(i) != "none" else cfg.ffn_at(i)
             for i in range(cfg.num_layers)]
    assert (kinds.count("ssm"), kinds.count("moe"), kinds.count("attn")) \
        == (23, 23, 6)
    assert mamba2.ssm_dims(cfg) == (4096, 64)
    from repro_torch.launch import roofline
    total, _ = roofline.param_counts(cfg)
    assert 31.5e9 < total < 31.7e9
    cut = cfg.replace(num_layers=14, experts_held=16)
    assert cut.pattern_len == 14 and cut.layer_pattern[:14] == "MEMEM*EMEMEM*E"
    assert 2.06e9 < roofline.param_counts(cut)[0] < 2.07e9


def test_logits_loss_and_every_gradient_match_the_reference():
    """f32 at smoke size, with the capacity's drops (cf 1.25): the loss
    and logits to 1e-5, every gradient leaf to 1e-4 of its norm."""
    cfg = get_smoke_config(ARCH)
    c = ref_config(cfg)
    params = tfm.init_params(cfg, seed=3, device="cpu")
    batch = _batch(cfg)
    logits, _, _, _ = tfm.forward(params, batch, cfg, "train")
    want = ref.forward(params, batch["tokens"], c)
    assert _rel(logits, want) < 1e-5
    from repro_torch.training.train_loop import value_and_grad
    (loss, _), grads = value_and_grad(
        lambda p, b: tfm.loss_fn(p, b, cfg), params, batch)
    rloss, rgrads = ref.grads(params, batch, c)
    assert abs(float(loss) - rloss) < 1e-5 * abs(rloss)
    flat = dict(ref.leaves(grads))
    assert set(flat) == set(rgrads)
    for k, g in rgrads.items():
        if k.endswith("router_bias"):
            assert not flat[k].any() and not g.any(), k
            continue
        assert _rel(flat[k], g) < 1e-4, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_weights_have_the_programs_layout(dtype):
    """The reference's seeded weights are the program's tree: its keys,
    shapes and dtypes (one held shard of the experts), and the program
    runs on them."""
    cfg = get_smoke_config(ARCH).replace(experts_held=2, expert_shard=3,
                                         param_dtype=dtype, dtype=dtype)
    mine = dict(ref.leaves(ref.make_params(ref_config(cfg), 5)))
    prog = dict(ref.leaves(tfm.init_params(cfg, seed=5, device="cpu")))
    assert sorted(mine) == sorted(prog)
    for k, t in prog.items():
        assert (mine[k].shape, mine[k].dtype) == (t.shape, t.dtype), k
    again = dict(ref.leaves(ref.make_params(ref_config(cfg), 5)))
    assert all(torch.equal(again[k], t) for k, t in mine.items())
    logits = tfm.forward(ref.make_params(ref_config(cfg), 5), _batch(cfg),
                         cfg, "train")[0]
    assert torch.isfinite(logits.float()).all()


def test_replayed_choice_is_the_programs_routing():
    """The program's recorded choice, one per MoE layer: replayed by the
    reference in float32, it is the reference's own (no pair outside its
    top-k) and gives the same logits; a replayed choice that is not the
    reference's own is counted and moves them."""
    cfg = get_smoke_config(ARCH)
    c = ref_config(cfg)
    params = ref.make_params(c, 4)
    batch = _batch(cfg)
    with moe.recorded_choices() as taps:
        logits = tfm.forward(params, batch, cfg, "train")[0]
    assert len(taps) == ref.pattern(c).count("E")
    assert not moe._CHOICE_TAPS
    r = ref.Routes(list(taps))
    want = ref.forward(params, batch["tokens"], c, routes=r)
    assert ref.differ_share([r]) == 0.0
    assert _rel(logits, want) < 1e-5
    assert all(torch.equal(a, b) for a, b in zip(r.choices(), taps))
    other = ref.Routes([t.flip(-1).roll(1, 0) for t in taps])
    moved = ref.forward(params, batch["tokens"], c, routes=other)
    assert ref.differ_share([other]) > 0.1 and _rel(moved, want) > 1e-3


@pytest.mark.parametrize("prompt", [21, 37])
def test_prefill_then_decode_match_the_reference_forward(prompt):
    """Prefill ``prompt`` tokens, place the caches, decode the rest one
    token at a time: every position's logits against the reference's one
    forward over all 40 (a capacity no pair can reach, so that the
    prefill's and each step's tokens route as the whole batch's do)."""
    cfg = get_smoke_config(ARCH).replace(capacity_factor=4.0)
    params = tfm.init_params(cfg, seed=5, device="cpu")
    tokens = _batch(cfg, S=40, seed=1)["tokens"]
    want = ref.forward(params, tokens, ref_config(cfg))
    logits, caches = tfm.prefill_step(params, {"tokens": tokens[:, :prompt]},
                                      cfg)
    assert _rel(logits, want[:, :prompt]) < 1e-5
    caches = tfm.place_caches(cfg, caches, tokens.shape[1])
    for t in range(prompt, tokens.shape[1]):
        logits, caches = tfm.decode_step(
            params, {"tokens": tokens[:, t:t + 1]}, cfg, caches, t)
        assert _rel(logits[:, 0], want[:, t]) < 1e-5, t


def _scan_inputs(G, H=8, Bt=2, S=45, P=16, N=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(Bt, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(Bt, S, H, generator=g))
    B = torch.randn(Bt, S, G, N, generator=g)
    C = torch.randn(Bt, S, G, N, generator=g)
    A = -torch.rand(H, generator=g) - 0.5
    return x, dt, B, C, A


def _per_group(x, dt, B, C, A, chunk):
    """The grouped scan as G scans of one group over its heads, each the
    reference's minimal SSD (the Mamba2 paper's listing)."""
    G, per = B.shape[2], x.shape[2] // B.shape[2]
    outs = []
    for g in range(G):
        h = slice(g * per, (g + 1) * per)
        Bg, Cg = (t[:, :, g, None].expand(-1, -1, per, -1) for t in (B, C))
        y, st = ref.ssd(x[:, :, h] * dt[:, :, h, None], dt[:, :, h] * A[h],
                        Bg, Cg, chunk)
        outs.append((y, st))
    return (torch.cat([o[0] for o in outs], 2),
            torch.cat([o[1] for o in outs], 1))


def test_one_group_is_the_shared_scan_bit_for_bit():
    x, dt, B, C, A = _scan_inputs(1)
    shared = ssd_ops.ssd_scan_plain(x, dt, B[:, :, 0], C[:, :, 0], A, 16)
    grouped = ssd_ops.ssd_scan_plain(x, dt, B, C, A, 16)
    for a, b in zip(shared, grouped):
        assert torch.equal(a, b)
    st = torch.randn(2, 8, 16, 8)
    one = mamba2.ssd_decode_step(x[:, 0], dt[:, 0], B[:, 0, 0], C[:, 0, 0],
                                 A, st)
    two = mamba2.ssd_decode_step(x[:, 0], dt[:, 0], B[:, 0], C[:, 0], A, st)
    assert torch.equal(one[1], two[1])
    assert torch.allclose(one[0], two[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("G", [2, 4])
def test_grouped_scan_forward_and_backward_match_a_loop_over_groups(G):
    x, dt, B, C, A = _scan_inputs(G)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, B, C, A)]
    y, st = ssd_ops.ssd_scan_plain(*ins, 16)
    loop = [t.clone().requires_grad_(True) for t in (x, dt, B, C, A)]
    ly, lst = _per_group(*loop, 16)
    assert torch.allclose(y, ly, rtol=1e-5, atol=1e-5)
    assert torch.allclose(st, lst, rtol=1e-5, atol=1e-5)
    gy, gs = torch.randn_like(y), torch.randn_like(st)
    want = torch.autograd.grad((ly, lst), loop, (gy, gs))
    got = torch.autograd.grad((y, st), ins, (gy, gs))
    # the card's backward: the plain version's recompute
    card = ssd_ops.ssd_scan_backward(x, dt, B, C, A, 16, gy, gs)
    for a, b, w in zip(got, card, want):
        assert _rel(a, w) < 1e-5 and _rel(b, w) < 1e-5


@pytest.mark.parametrize("G", [2, 4])
def test_grouped_decode_step_matches_a_loop_over_groups(G):
    x, dt, B, C, A = _scan_inputs(G)
    state = torch.randn(2, 8, 16, 8)
    y, new = mamba2.ssd_decode_step(x[:, 0], dt[:, 0], B[:, 0], C[:, 0], A,
                                    state)
    per = 8 // G
    for g in range(G):
        hs = slice(g * per, (g + 1) * per)
        yg, ng = mamba2.ssd_decode_step(x[:, 0, hs], dt[:, 0, hs],
                                        B[:, 0, g], C[:, 0, g], A[hs],
                                        state[:, hs])
        assert torch.allclose(y[:, hs], yg, atol=1e-5, rtol=1e-5)
        assert torch.allclose(new[:, hs], ng, atol=1e-5, rtol=1e-5)
    # the scan's final state is what the steps reach
    _, st = ssd_ops.ssd_scan_plain(x, dt, B, C, A, 16)
    s = torch.zeros_like(st)
    for t in range(x.shape[1]):
        _, s = mamba2.ssd_decode_step(x[:, t], dt[:, t], B[:, t], C[:, t],
                                      A, s)
    assert _rel(s, st) < 1e-5


def test_sigmoid_router_chooses_with_the_bias_and_weighs_without():
    g = torch.Generator().manual_seed(2)
    T, d, E, k = 64, 16, 8, 2
    xf, router = torch.randn(T, d, generator=g), torch.randn(d, E,
                                                             generator=g)
    bias = torch.zeros(E)
    bias[5] = 10.0                       # expert 5 chosen by every token
    r = moe.route(router, xf, k, 1.25, bias, 2.5)
    s = torch.sigmoid(xf @ router)
    assert (r.idx[:, 0] == 5).all()
    other = torch.sort(s.masked_fill(torch.arange(E) == 5, -1), dim=-1,
                       descending=True, stable=True).indices[:, 0]
    assert torch.equal(r.idx[:, 1], other)
    w = s.gather(1, r.idx)
    assert torch.allclose(r.gates, w / w.sum(-1, keepdim=True) * 2.5)
    assert r.cap == moe.capacity(T, k, E, 1.25)
    # the reference routes the same pairs and keeps the same ones
    p = {"router": router, "router_bias": bias}
    c = {"num_experts_per_tok": k, "router_outputs": E,
         "routed_scaling_factor": 2.5, "capacity_factor": 1.25}
    choice, wr, kept = ref.route(p, xf, c)
    assert torch.equal(choice, r.idx) and torch.equal(kept, r.keep)
    assert torch.allclose(wr, r.gates)
    assert not r.keep[:, 0].all()        # expert 5 overflows its capacity


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """8 shards of the smoke layer's 8 experts, one each, on the port's
    layer told which experts it holds: their routed parts, plus the
    shared expert once, equal the reference's uncut layer (drops
    included: every shard routes over all 8 with the same capacity)."""
    cfg = get_smoke_config(ARCH)
    params = tfm.init_params(cfg, seed=9, device="cpu")
    p = tfm._index(params["blocks"], 0)["i1"]["ffn"]
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    n = 8
    held = cfg.num_experts // n
    shared = moe.shared_expert(p, x, cfg)
    total = shared.clone()
    for m in range(n):
        scfg = cfg.replace(experts_held=held, expert_shard=m)
        part = {k: v[m * held:(m + 1) * held]
                if k in ("w_up", "w_down") else v for k, v in p.items()}
        y, lb, z = moe.moe_forward(part, x, scfg)
        assert float(lb) == float(z) == 0.0
        total = total + (y - shared)
    want = ref.moe({k: v.float() for k, v in p.items()}, x, ref_config(cfg),
                   None)
    assert _rel(total, want) < 1e-5


def test_slot_counter_counts_the_held_experts_pairs():
    from repro_torch.obs import REGISTRY
    cfg = get_smoke_config(ARCH).replace(experts_held=2, expert_shard=1)
    params = tfm.init_params(cfg, seed=1, device="cpu")
    p = tfm._index(params["blocks"], 0)["i1"]["ffn"]
    x = torch.randn(2, 40, cfg.d_model)

    def read():
        return {o: REGISTRY.value(moe.SLOTS_TOTAL, outcome=o)
                for o in ("kept", "dropped")}
    before = read()
    moe.moe_forward(p, x, cfg)
    after = read()
    r = moe.route(p["router"], x.reshape(-1, cfg.d_model),
                  cfg.experts_per_token, cfg.capacity_factor,
                  p["router_bias"], cfg.routed_scaling)
    mine = (r.idx >= 2) & (r.idx < 4)
    assert after["kept"] - before["kept"] == int((mine & r.keep).sum())
    assert after["dropped"] - before["dropped"] == int((mine & ~r.keep).sum())


def test_slot_counts_wait_on_the_device_until_the_registry_is_read():
    """A layer's call adds its counts to a device total and reads nothing
    back; a read of the registry folds the total in, once."""
    from repro_torch.obs import REGISTRY
    cfg = get_smoke_config(ARCH).replace(experts_held=2, expert_shard=1)
    params = tfm.init_params(cfg, seed=1, device="cpu")
    p = tfm._index(params["blocks"], 0)["i1"]["ffn"]
    x = torch.randn(2, 40, cfg.d_model)
    REGISTRY.snapshot()
    assert not moe._PENDING_SLOTS
    moe.moe_forward(p, x, cfg)
    moe.moe_forward(p, x, cfg)
    (total,) = moe._PENDING_SLOTS.values()
    kept = REGISTRY.value(moe.SLOTS_TOTAL, outcome="kept")
    assert not moe._PENDING_SLOTS
    assert total.tolist()[0] > 0
    assert REGISTRY.value(moe.SLOTS_TOTAL, outcome="kept") == kept


def test_launchers_train_and_generate_on_the_cpu(tmp_path, capsys):
    ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                 "3", "--seq-len", "32", "--batch-size", "2", "--ckpt-dir",
                 str(tmp_path)])
    assert "trained to step 3" in capsys.readouterr().out
    tserve.serve_lm(argparse.Namespace(arch=ARCH, device="cpu",
                                       decode_steps=2))
    assert capsys.readouterr().out.startswith(f"{ARCH}: prefill 32 tokens")


def test_the_benchmarks_reference_is_this_one():
    bench = ROOT / "capsim_bench" / "reference" / "nemotron_h.py"
    assert bench.read_text() == (ROOT / "tests" /
                                 "nemotron_h_reference.py").read_text()
