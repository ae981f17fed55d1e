"""Plain PyTorch CAPSim predictor (paper §III and §V, Eq 5-11): the
parameter tree, the forward pass, the MAPE loss and the SGD-momentum step
with global-norm clipping.  It imports nothing of the program: it is
written from the equations and the sizes of ``configs/*.json``, so that a
fault in the program cannot hide in it.

The forward follows the program's published conventions: pre-norm RMS
layers ``x·rsqrt(mean(x²)+1e-6)·(1+g)``, token id 0 as padding (a query
row with no valid key attends to nothing and gives zeros), the <REP>
slot (row 0) of each instruction as its vector, sinusoidal positions on
the clip's rows, the head's per-row scalar averaged over the context
rows, then softplus times the clip's instruction count.

``dtype`` is the compute precision the configuration states: float32
(TF32 off) for training, bfloat16 products over float32 weights for
serving, with the norms, softmax and sums in float32 as the configuration
states them.  ``quant`` names a lower precision for the control of the
output check: ``"fp8"`` rounds every operand of every product to float8
e4m3 with a per-tensor scale, as an fp8 deployment would.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0


def tree_shapes(c: dict) -> Dict[str, object]:
    """{leaf path: (shape, std)}: dense weights (d_in, d_out) drawn with
    std 1/sqrt(d_in), the embedding with 1/sqrt(E), norm gains and biases
    with 0.1; per-layer leaves carry a leading layer axis."""
    E, HD, Fd, V = (c["d_model"], c["num_heads"] * c["head_dim"],
                    c["d_ff"], c["vocab_size"])
    small = 0.1

    def dense(a, b):
        return ((a, b), 1.0 / math.sqrt(a))

    def mha(prefix=""):
        return {f"{prefix}wq": dense(E, HD), f"{prefix}wk": dense(E, HD),
                f"{prefix}wv": dense(E, HD), f"{prefix}wo": dense(HD, E)}

    def stack(d, n):
        return {k: ((n,) + s, std) for k, (s, std) in d.items()}

    inst = {**mha(), "w1": dense(E, Fd), "w2": dense(Fd, E),
            "norm1": ((E,), small), "norm2": ((E,), small)}
    block = {**mha("self_"), **mha("cross_"), "w1": dense(E, Fd),
             "w2": dense(Fd, E), "norm1": ((E,), small),
             "norm2": ((E,), small), "norm3": ((E,), small)}
    return {"embed": ((V, E), 1.0 / math.sqrt(E)),
            "inst": stack(inst, c["n_inst_layers"]),
            "block": stack(block, c["n_block_layers"]),
            "final_norm": ((E,), small),
            "head": {"w1": dense(E, E), "b1": ((E,), small),
                     "w2": dense(E, 1), "b2": ((1,), small)}}


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


def make_params(c: dict, seed: int, device) -> dict:
    """The weights from ``seed``, drawn on ``device`` in one call from a
    generator of that device, then cut into the tree's leaves."""
    shapes = tree_shapes(c)
    flat = list(leaves(shapes))
    sizes = [math.prod(s[0]) for _, s in flat]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draw = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out: dict = {}
    off = 0
    for (path, (shape, std)), n in zip(flat, sizes):
        node = out
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = (draw[off:off + n] * std).reshape(shape)
        off += n
    return out


def _q(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``x`` rounded to the control's precision (per-tensor scale), in
    its own dtype."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown precision {quant!r}")
    xf = x.float()
    scale = xf.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return ((xf / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _mm(a, w, dt, quant):
    """A product in the compute dtype ``dt``: the weight cast at use."""
    return _q(a, quant) @ _q(w.to(dt), quant)


def rms(x, g):
    """In float32 whatever ``x`` is, cast back to its dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + EPS)
    return (y * (1 + g.float())).to(x.dtype)


def attention(q, k, v, kv_mask, quant):
    """q (B, Sq, H, D), k/v (B, Skv, H, D); kv_mask (B, Skv) 1 = valid or
    None.  Scores, softmax and sums in float32; a query with no valid key
    gives zeros; the output in q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", _q(q, quant).float(),
                     _q(k, quant).float()) / math.sqrt(q.shape[-1])
    if kv_mask is not None:
        valid = (kv_mask > 0)[:, None, None, :]
        s = s.masked_fill(~valid, float("-inf"))
        p = torch.softmax(s, -1)
        p = torch.where(valid.any(-1, keepdim=True), p, torch.zeros_like(p))
    else:
        p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        _q(v, quant).float()).to(q.dtype)


def mha(p, pre, xq, xkv, kv_mask, c, dt, quant):
    H, D = c["num_heads"], c["head_dim"]
    q = _mm(xq, p[pre + "wq"], dt, quant).unflatten(-1, (H, D))
    k = _mm(xkv, p[pre + "wk"], dt, quant).unflatten(-1, (H, D))
    v = _mm(xkv, p[pre + "wv"], dt, quant).unflatten(-1, (H, D))
    o = attention(q, k, v, kv_mask, quant).flatten(-2)
    return _mm(o, p[pre + "wo"], dt, quant)


def ffn(p, x, dt, quant):
    return _mm(F.gelu(_mm(x, p["w1"], dt, quant), approximate="tanh"),
               p["w2"], dt, quant)


def sinusoidal(n: int, e: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(e // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2.0 * dim / e)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _layer(stacked, i):
    return {k: v[i] for k, v in stacked.items()}


def forward(params, clip_tokens, context_tokens, clip_mask, c: dict,
            quant: Optional[str] = None, dtype: str = "float32"
            ) -> torch.Tensor:
    """Predicted cycles of each clip (B,), in float32.  ``dtype`` is the
    compute dtype of the products and the residual stream (the weights
    stay float32 and are cast at use); norms, softmax and the head's mean
    run in float32."""
    dt = getattr(torch, dtype)
    B, L, T = clip_tokens.shape
    flat = clip_tokens.reshape(B * L, T).long()
    tmask = (flat != 0).float()
    x = params["embed"][flat].to(dt)
    for i in range(c["n_inst_layers"]):
        lp = _layer(params["inst"], i)
        h = rms(x, lp["norm1"])
        x = x + mha(lp, "", h, h, tmask, c, dt, quant)
        x = x + ffn(lp, rms(x, lp["norm2"]), dt, quant)
    rt = x[:, 0, :].reshape(B, L, -1)
    rt = rt + sinusoidal(L, rt.shape[-1], rt.device).to(dt)[None]
    cm = clip_mask.float()
    h = params["embed"][context_tokens.long()].to(dt)
    for i in range(c["n_block_layers"]):
        lp = _layer(params["block"], i)
        n1 = rms(h, lp["norm1"])
        h = h + mha(lp, "self_", n1, n1, None, c, dt, quant)
        h = h + mha(lp, "cross_", rms(h, lp["norm2"]), rt, cm, c, dt, quant)
        h = h + ffn(lp, rms(h, lp["norm3"]), dt, quant)
    hw = params["head"]
    y = F.gelu(_mm(rms(h, params["final_norm"]), hw["w1"], dt, quant)
               + hw["b1"].to(dt), approximate="tanh")
    y = (_mm(y, hw["w2"], dt, quant) + hw["b2"].to(dt))[..., 0].float()
    n_inst = cm.sum(-1).clamp(min=1.0)
    return F.softplus(y.mean(-1)) * n_inst


def block_rows(c: dict) -> int:
    """Clips a block of the reference takes at once: 64 at the paper's
    360 context rows, fewer where the context's squared width is larger."""
    return max(4, 64 * 360 ** 2 // c["context_tokens"] ** 2)


def predict(params, clips: dict, c: dict, quant: Optional[str] = None,
            dtype: str = "float32") -> torch.Tensor:
    """``forward`` over many clips in blocks of rows, so that it fits;
    ``clips`` holds device tensors."""
    n, block = clips["clip_tokens"].shape[0], block_rows(c)
    with torch.no_grad():
        return torch.cat([forward(params, clips["clip_tokens"][i:i + block],
                                  clips["context_tokens"][i:i + block],
                                  clips["clip_mask"][i:i + block], c, quant,
                                  dtype)
                          for i in range(0, n, block)])


def mape_grads(params, batch: dict, c: dict, rows: Optional[int] = None):
    """(MAPE over the batch, its gradient tree), accumulated over blocks
    of rows.  ``rows`` takes only the first rows of the batch (a planted
    fault: half of the batch left out)."""
    n = batch["clip_tokens"].shape[0] if rows is None else rows
    block = block_rows(c)
    live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    total = torch.zeros((), dtype=torch.float64,
                        device=batch["time"].device)
    with torch.enable_grad():
        for i in range(0, n, block):
            j = min(i + block, n)
            pred = forward(live, batch["clip_tokens"][i:j],
                           batch["context_tokens"][i:j],
                           batch["clip_mask"][i:j], c)
            fact = batch["time"][i:j].float().clamp(min=1.0)
            part = ((pred - fact).abs() / fact).sum() / n
            part.backward()
            total += part.detach().double()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), live)
    return float(total), grads


def lr_at(step: int, s: dict) -> float:
    """The warm-up-then-cosine rate of the launcher's recipe at ``step``
    (0-based): linear from 0 over ``warmup_steps``, then a cosine down to
    a tenth of ``base_lr`` at ``total_steps``."""
    base, warm, total = s["base_lr"], s["warmup_steps"], s["total_steps"]
    if step < warm:
        return base * step / max(1.0, warm)
    prog = min(max((step - warm) / max(1.0, total - warm), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def sgdm_steps(params, batches_: List[dict], c: dict, s: dict,
               rows: Optional[int] = None):
    """The SGD-momentum steps over ``batches_`` from ``params``: each
    gradient scaled to a global norm of at most ``grad_clip``, the
    momentum ``mu = momentum·mu + g``, ``p -= lr·mu``.  Returns (losses,
    the first step's clipped gradient, the parameters after the last)."""
    p = tree_map(lambda x: x.detach().clone(), params)
    mu = tree_map(torch.zeros_like, params)
    losses, first = [], None
    for i, b in enumerate(batches_):
        loss, g = mape_grads(p, b, c, rows=rows)
        losses.append(loss)
        gn = math.sqrt(sum(float(x.double().square().sum())
                           for _, x in leaves(g)))
        scale = min(1.0, s["grad_clip"] / max(gn, 1e-12))
        g = tree_map(lambda x: x * scale, g)
        if first is None:
            first = g
        mu = tree_map(lambda m, x: s["momentum"] * m + x, mu, g)
        lr = lr_at(i, s)
        p = tree_map(lambda x, m: x - lr * m, p, mu)
    return losses, first, p
