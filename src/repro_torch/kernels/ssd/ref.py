"""Oracle for the SSD (Mamba2) scan: the naive per-timestep recurrence
(port of ``repro/kernels/ssd/ref.py``).  Deliberately a different
algorithm from the chunked kernel and its plain version, so agreement is
meaningful:

    state_t = state_{t-1} * exp(dt_t * A) + dt_t * B_t x_t^T
    y_t     = C_t . state_t
"""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, A: torch.Tensor):
    """x: (Bt, S, H, P); dt: (Bt, S, H) positive; B/C: (Bt, S, N);
    A: (H,) negative.  Returns (y (Bt, S, H, P) in x's dtype, state
    (Bt, H, P, N) f32)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    state = torch.zeros(Bt, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])              # (Bt, H)
        upd = torch.einsum("bn,bh,bhp->bhpn", Bf[:, t], dtf[:, t], xf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y, state
