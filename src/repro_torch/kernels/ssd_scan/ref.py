"""Sequential oracle for the SSD (Mamba-2) chunked scan; port of
``repro/kernels/ssd_scan/ref.py``.  The per-timestep recurrence is the
ground truth the chunked forms (``models.ssm.ssd_chunked`` and the kernel)
must match:

    S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t (outer) B_t
    y_t = C_t . S_t
"""

from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C):
    """x: [b, S, H, P]; dt: [b, S, H]; A: [H]; B, C: [b, S, N].

    Returns (y: [b, S, H, P], final_state: [b, H, P, N]) in float32.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)                                   # [b, H]
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1), state
