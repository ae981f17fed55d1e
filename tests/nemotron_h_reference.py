"""Plain PyTorch NemotronH (NVIDIA-Nemotron-3-Nano-30B-A3B): the forward
pass, the causal-LM loss, its gradients and AdamW steps with global-norm
clipping, in float32 with TF32 off.  It imports nothing of the program
and no kernel: it is written from the published equations (the model
card's config.json and the NemotronH modelling code), so that a fault in
the program cannot hide in it.

``c`` is a configuration under the published keys (``hidden_size``,
``hybrid_override_pattern``, ``n_groups`` ...), with the deployment's
keys beside them: ``router_outputs`` (the router's width, all the
experts of the model), ``n_routed_experts`` (the experts held here),
``expert_shard`` (which block of them) and ``capacity_factor``.

Each of the first ``num_hidden_layers`` letters of the pattern is one
layer ``x = x + op(RMSNorm(x))``, then a final RMSNorm and the untied
head:

- ``M``, the Mamba2 mixer: ``z, x, B, C, dt`` from five products of h;
  ``x, B, C = silu(conv(·) + bias)`` (causal depthwise, width
  ``conv_kernel``); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
  ``y = SSD(x, dt, A, B, C) + D·x`` with head h reading group h // (H /
  G), the scan in chunks of ``chunk_size`` as the Mamba2 paper's minimal
  listing (a segment sum, the diagonal blocks, the chunk states, the pass
  over chunks, the off-diagonal blocks); ``y = RMSNorm over groups of
  d_inner / G channels of (y·silu(z))``, then the out product.
- ``E``, the MoE: ``s = sigmoid(h·W_r)``; the top-k of ``s + b`` (``b``
  the correction bias, for the choice only; ties to the lower expert);
  weights ``s`` of the chosen, over their sum (+1e-20), times
  ``routed_scaling_factor``; each expert ``down(relu(up·h)²)``, the
  shared expert alike, added once.
- ``*``, causal GQA attention, head h reading KV head h // (H / KV),
  scaled by 1/sqrt(head_dim), no positional rotation (the modelling
  code applies none).

``make_params`` draws the weights from a seed in the program's tree
layout (keys and shapes, a leading axis of 1 on each layer's leaves,
the dtypes the configuration states), so the program is fed the
reference's weights.

``Routes`` replays another model's expert choice: a forward given one
takes, in each MoE layer, the given (T, k) choice in place of its own
top-k; the weights are still its own scores at the chosen experts, and
the kept pairs come from the capacity rule below.  It also counts the
pairs of the choice taken that lie outside the layer's own top-k.  A
model in a lower precision flips choices near ties, and each flip moves
a token's output by a whole expert's share (and, past a full expert,
which pair is dropped): replaying the choice separates that from the
rounding of every product.

Departures, each the program's stated deployment and none a shortcut:
norm weights are stored as ``1 + g`` (the program's parametrization; the
same function); the MoE keeps a (token, slot) pair while its position,
the running count of its expert in flattened (token, slot) order over
every token of the batch, is below ``capacity(T, k, E, cf) =
max(8, ceil(cf·T·k/E) rounded up to 8)`` (the published model drops
none; 1.25 is assumed); and the layer computes only the held experts'
part of the routed sum, as one rank of the expert-parallel deployment
would before its exchange.  Parameters come in the program's tree
layout (keys and shapes, a leading axis of 1 on each layer's leaves);
the reference computes in float32 and stores each updated leaf back in
its own dtype, as the configuration states its parameters (bfloat16,
with float32 optimizer state).

``quant="fp8"`` rounds every operand of every product with a weight, and
attention's two products, to float8 e4m3 with a per-tensor scale: the
control one precision below the configuration's bfloat16.  The gradient
passes the rounding unchanged (a float8 cast would round it too, to
zeros), so the backward's products take the rounded operands and
float32 gradients.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def leaves(tree, prefix: str = "") -> Iterator:
    """(path, leaf) in sorted key order; paths join keys with "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + k + "/")
    else:
        yield prefix[:-1], tree


def tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the block, restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _q(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(quant)
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())       # the gradient passes unchanged


def _mm(a, w, quant):
    return _q(a, quant) @ _q(w, quant)


def rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + g)


def segsum(x):
    """(.., T) -> (.., T, T): sum of x over (j, i] below the diagonal, 0
    on it, -inf above (the Mamba2 paper's stable segment sum)."""
    T = x.shape[-1]
    xe = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    s = torch.cumsum(xe.masked_fill(~low, 0), dim=-2)
    on = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return s.masked_fill(~on, -torch.inf)


def ssd(X, A, B, C, block: int):
    """The Mamba2 paper's minimal SSD: X (b, l, h, p) already times dt, A
    (b, l, h) = dt·A, B/C (b, l, h, n).  Returns (y (b, l, h, p), final
    state (b, h, p, n))."""
    b, l, h, p = X.shape
    q = min(block, l)
    pad = -l % q
    if pad:
        X, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (X, B, C))
        A = F.pad(A, (0, 0, 0, pad))
    nc = (l + pad) // q
    X = X.view(b, nc, q, h, p)
    B = B.reshape(b, nc, q, h, -1)
    C = C.reshape(b, nc, q, h, -1)
    A = A.view(b, nc, q, h).permute(0, 3, 1, 2)            # (b, h, c, l)
    A_cum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, L, X)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final = new_states[:, :-1], new_states[:, -1]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(A_cum))
    y = (Y_diag + Y_off).reshape(b, nc * q, h, p)[:, :l]
    return y, final


def _conv(x, w, bias):
    """Causal depthwise convolution (B, S, C) by (W, C), plus bias, then
    SiLU."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    return F.silu(y + bias)


def mamba(p, h, c, quant):
    Bt, S, _ = h.shape
    H, P = c["mamba_num_heads"], c["mamba_head_dim"]
    G, N = c["n_groups"], c["ssm_state_size"]
    z = _mm(h, p["wz"], quant)
    x = _conv(_mm(h, p["wx"], quant), p["conv_x"], p["conv_x_bias"])
    Bm = _conv(_mm(h, p["wB"], quant), p["conv_B"], p["conv_B_bias"])
    Cm = _conv(_mm(h, p["wC"], quant), p["conv_C"], p["conv_C_bias"])
    dt = F.softplus(_mm(h, p["wdt"], quant) + p["dt_bias"])   # (Bt, S, H)
    A = -torch.exp(p["A_log"])
    xh = x.view(Bt, S, H, P)
    per = H // G
    Bh = Bm.view(Bt, S, G, N).repeat_interleave(per, dim=2)
    Ch = Cm.view(Bt, S, G, N).repeat_interleave(per, dim=2)
    y, _ = ssd(xh * dt[..., None], dt * A, Bh, Ch, c["chunk_size"])
    y = y + xh * p["D"][:, None]
    g = (y.reshape(Bt, S, H * P) * F.silu(z)).unflatten(-1, (G, -1))
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + _eps(c))
    g = g.flatten(-2) * (1 + p["gate_norm"])
    return _mm(g, p["out_proj"], quant)


def attention(p, h, c, quant):
    Bt, S, _ = h.shape
    H, KV, D = (c["num_attention_heads"], c["num_key_value_heads"],
                c["head_dim"])
    q = _mm(h, p["wq"], quant).view(Bt, S, H, D).transpose(1, 2)
    k = _mm(h, p["wk"], quant).view(Bt, S, KV, D).transpose(1, 2)
    v = _mm(h, p["wv"], quant).view(Bt, S, KV, D).transpose(1, 2)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    outs = []
    for r in range(Bt):            # one row's scores at a time
        s = _mm(q[r], k[r].transpose(-1, -2), quant) / math.sqrt(D)
        a = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        outs.append(_mm(a, v[r], quant))
    o = torch.stack(outs).transpose(1, 2).reshape(Bt, S, H * D)
    return _mm(o, p["wo"], quant)


def capacity(tokens: int, k: int, experts: int, cf: float) -> int:
    n = int(math.ceil(cf * tokens * k / experts))
    return max(8, (n + 7) // 8 * 8)


class Routes:
    """The MoE layers' expert choice in one forward (and its remat
    recompute).  ``force``: one (T, k) choice per MoE layer, in layer
    order, taken in place of the layers' own top-k; ``None``: each layer
    chooses.  ``chosen[j]`` is MoE layer j's choice as taken, and
    ``differ[j]`` how many of its pairs lie outside the layer's own
    top-k."""

    def __init__(self, force: Optional[List[torch.Tensor]] = None):
        self.force = force
        self.chosen: Dict[int, torch.Tensor] = {}
        self.differ: Dict[int, int] = {}

    def choices(self) -> List[torch.Tensor]:
        return [self.chosen[j] for j in sorted(self.chosen)]


def differ_share(routes: List[Routes]) -> float:
    """Of the pairs the forwards took, the share outside the layers' own
    top-k."""
    n = sum(sum(r.differ.values()) for r in routes)
    return n / max(1, sum(t.numel() for r in routes for t in r.choices()))


def route(p, hf, c, quant=None, routes: Optional[Routes] = None,
          j: int = 0):
    """(chosen experts (T, k), weights (T, k), kept (T, k)) over all the
    router's experts; ``routes``: MoE layer j's replayed choice and
    record."""
    T = hf.shape[0]
    k, E = c["num_experts_per_tok"], c["router_outputs"]
    s = torch.sigmoid(_mm(hf, p["router"], quant))
    choice = torch.sort(s + p["router_bias"], dim=-1, descending=True,
                        stable=True).indices[:, :k]
    if routes is not None:
        own = choice
        if routes.force is not None:
            choice = routes.force[j].to(hf.device)
        routes.chosen[j] = choice.detach()
        inside = (choice[:, :, None] == own[:, None, :]).any(-1)
        routes.differ[j] = int((~inside).sum())
    w = s.gather(1, choice)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]
    flat = choice.reshape(-1)
    one = F.one_hot(flat, E)
    pos = ((torch.cumsum(one, 0) - one) * one).sum(-1).view(T, k)
    return choice, w, pos < capacity(T, k, E, c["capacity_factor"])


def relu2(x):
    return torch.relu(x).square()


def moe(p, h, c, quant, routes=None, j=0):
    Bt, S, d = h.shape
    hf = h.reshape(-1, d)
    choice, w, kept = route(p, hf, c, quant, routes, j)
    held = c["n_routed_experts"]
    first = c["expert_shard"] * held
    y = torch.zeros_like(hf)
    for e in range(held):
        t, j = torch.nonzero((choice == first + e) & kept, as_tuple=True)
        if t.numel():
            out = _mm(relu2(_mm(hf[t], p["w_up"][e], quant)),
                      p["w_down"][e], quant)
            y = y.index_add(0, t, out * w[t, j, None])
    y = y + _mm(relu2(_mm(hf, p["shared_up"], quant)), p["shared_down"],
                quant)
    return y.view(Bt, S, d)


def _eps(c):
    return c["layer_norm_epsilon"]


def _layer(params, j):
    return tree_map(lambda t: t[0].float(), params["blocks"][f"i{j}"])


def pattern(c) -> str:
    return c["hybrid_override_pattern"][:c["num_hidden_layers"]]


def forward(params, tokens, c: dict, quant: Optional[str] = None,
            remat: bool = False, routes: Optional[Routes] = None):
    """Logits (B, S, V) in float32 of ``tokens`` (B, S).  ``remat``
    recomputes each layer in the backward (no change to the numbers: the
    full model's activations at the published widths would not fit);
    ``routes`` replays and records the MoE layers' choice."""
    with no_tf32():
        return _forward(params, tokens, c, quant, remat, routes)


def _forward(params, tokens, c, quant, remat, routes):
    x = params["embed"].float()[tokens]
    n_moe = 0
    for j, op in enumerate(pattern(c)):
        p = _layer(params, j)

        def body(x, p=p, op=op, e=n_moe):
            if op == "E":
                return x + moe(p["ffn"], rms(x, p["norm2"]["scale"],
                                             _eps(c)), c, quant, routes, e)
            h = rms(x, p["norm1"]["scale"], _eps(c))
            if op == "M":
                return x + mamba(p["mixer"], h, c, quant)
            return x + attention(p["mixer"], h, c, quant)
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
        n_moe += op == "E"
    x = rms(x, params["final_norm"]["scale"].float(), _eps(c))
    return _mm(x, params["unembed"].float(), quant)


def loss(params, batch: dict, c: dict, quant: Optional[str] = None,
         remat: bool = False, routes: Optional[Routes] = None
         ) -> torch.Tensor:
    """Mean next-token cross-entropy over the masked positions."""
    logits = forward(params, batch["tokens"], c, quant, remat, routes)
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, batch["labels"][..., None].long())[..., 0]
    m = batch["loss_mask"].float()
    return (ce * m).sum() / m.sum().clamp(min=1.0)


def grads(params, batch: dict, c: dict, quant: Optional[str] = None,
          rows: Optional[int] = None, remat: bool = False,
          routes: Optional[Routes] = None):
    """(loss, {path: float32 gradient}) over the first ``rows`` rows of the
    batch (all without)."""
    if rows is not None:
        batch = {k: v[:rows] for k, v in batch.items()}
    live = tree_map(lambda t: t.detach().float().requires_grad_(True),
                    params)
    paths, ts = zip(*leaves(live))
    with torch.enable_grad(), no_tf32():
        lv = loss(live, batch, c, quant, remat, routes)
        gs = torch.autograd.grad(lv, ts, allow_unused=True)
    return float(lv.detach()), {k: torch.zeros_like(t) if g is None else g
                       for k, t, g in zip(paths, ts, gs)}


def lr_at(step: int, s: dict) -> float:
    """Linear warm-up from 0 over ``warmup_steps``, then a cosine to a
    tenth of ``base_lr`` at ``total_steps``."""
    base, warm, total = s["base_lr"], s["warmup_steps"], s["total_steps"]
    if step < warm:
        return base * step / max(1, warm)
    prog = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw_steps(params, batches: List[dict], c: dict, s: dict,
                quant: Optional[str] = None, rows: Optional[int] = None,
                remat: bool = False, routes: Optional[List[Routes]] = None,
                first_moment=None, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8):
    """AdamW (float32 moments, decay ``s["weight_decay"]``) over the
    batches from ``params``, the gradient clipped to a global norm of
    ``s["grad_clip"]``; ``routes``: one per batch; ``first_moment``, if
    given, is called with {path: first moment} after the first step.
    Returns (losses,
    {path: the float64 norm of the first moment after the first step},
    the parameters after the last step, each in its dtype)."""
    dtypes = {k: t.dtype for k, t in leaves(params)}
    cur = {k: t.float() for k, t in leaves(params)}
    mu = {k: torch.zeros_like(t) for k, t in cur.items()}
    nu = {k: torch.zeros_like(t) for k, t in cur.items()}
    losses, first_mu = [], None
    for i, b in enumerate(batches):
        lv, g = grads(_unflatten(cur), b, c, quant, rows, remat,
                      None if routes is None else routes[i])
        losses.append(lv)
        norm = math.sqrt(sum(float(v.double().square().sum())
                             for v in g.values()))
        scale = min(1.0, s["grad_clip"] / max(norm, 1e-12))
        lr = lr_at(i, s)
        for k in cur:
            gk = g.pop(k) * scale
            mu[k] = b1 * mu[k] + (1 - b1) * gk
            nu[k] = b2 * nu[k] + (1 - b2) * gk.square()
            upd = (mu[k] / (1 - b1 ** (i + 1))) / (
                torch.sqrt(nu[k] / (1 - b2 ** (i + 1))) + eps)
            upd = upd + s["weight_decay"] * cur[k]
            cur[k] = (cur[k] - lr * upd).to(dtypes[k]).float()
        if i == 0:
            first_mu = {k: math.sqrt(float(v.double().square().sum()))
                        for k, v in mu.items()}
            if first_moment is not None:
                first_moment(mu)
    return losses, first_mu, _unflatten(
        {k: v.to(dtypes[k]) for k, v in cur.items()})


def param_layout(c: dict) -> Dict[str, tuple]:
    """{path: (shape, dtype, std)} of the program's tree: ``std`` > 0 a
    normal draw, 0 zeros, -1 ones.  Matrices and the embedding have std
    1/sqrt(fan-in) (the embedding's the hidden size), the convolutions
    0.5 and their biases 0.1, the float32 router 1/sqrt(hidden) and its
    correction bias 0.05; A_log and D are ones, dt_bias and every norm's
    g (stored as 1 + g) zeros."""
    d, V = c["hidden_size"], c["vocab_size"]
    H, P, G, N = (c["mamba_num_heads"], c["mamba_head_dim"], c["n_groups"],
                  c["ssm_state_size"])
    di, gn, W = H * P, G * N, c["conv_kernel"]
    Ha, KV, D = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    f, fs = c["moe_intermediate_size"], c["moe_shared_expert_intermediate_size"]
    held, E = c["n_routed_experts"], c["router_outputs"]
    lo, f32 = getattr(torch, c["param_dtype"]), torch.float32

    def mat(a, b):
        return (a, b), lo, a ** -0.5
    ops = {
        "M": {"wz": mat(d, di), "wx": mat(d, di), "wB": mat(d, gn),
              "wC": mat(d, gn), "wdt": mat(d, H), "out_proj": mat(di, d),
              "conv_x": ((W, di), lo, 0.5), "conv_B": ((W, gn), lo, 0.5),
              "conv_C": ((W, gn), lo, 0.5),
              "A_log": ((H,), f32, -1), "D": ((H,), f32, -1),
              "dt_bias": ((H,), f32, 0), "gate_norm": ((di,), f32, 0)},
        "*": {"wq": mat(d, Ha * D), "wk": mat(d, KV * D),
              "wv": mat(d, KV * D), "wo": mat(Ha * D, d)},
        "E": {"router": ((d, E), f32, d ** -0.5),
              "router_bias": ((E,), f32, 0.05),
              "w_up": ((held, d, f), lo, d ** -0.5),
              "w_down": ((held, f, d), lo, f ** -0.5),
              "shared_up": mat(d, fs), "shared_down": mat(fs, d)}}
    if c["use_conv_bias"]:
        ops["M"].update(conv_x_bias=((di,), lo, 0.1),
                        conv_B_bias=((gn,), lo, 0.1),
                        conv_C_bias=((gn,), lo, 0.1))
    out = {"embed": ((V, d), lo, d ** -0.5), "unembed": ((d, V), lo, d ** -0.5),
           "final_norm/scale": ((d,), f32, 0)}
    for j, op in enumerate(pattern(c)):
        body, norm = ("ffn", "norm2") if op == "E" else ("mixer", "norm1")
        out[f"blocks/i{j}/{norm}/scale"] = ((1, d), f32, 0)
        for k, (shape, dt, std) in ops[op].items():
            out[f"blocks/i{j}/{body}/{k}"] = ((1, *shape), dt, std)
    return out


def make_params(c: dict, seed: int, device="cpu") -> dict:
    """The weights drawn from ``seed`` (``param_layout``), leaf by leaf in
    path order from one generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = {}
    for path, (shape, dt, std) in sorted(param_layout(c).items()):
        if std > 0:
            t = torch.randn(shape, generator=gen, device=device) * std
        else:
            t = torch.full(shape, float(-std), device=device)
        flat[path] = t.to(dt)
    return _unflatten(flat)


def _unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out
