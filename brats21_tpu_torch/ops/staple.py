"""STAPLE label fusion — EM on the card (replaces the reference's SimpleITK
``STAPLEImageFilter`` C++ call, transforms.py:650-687).

Port of ``brats21_tpu/ops/staple.py``. Warfield et al. 2002: given R binary
rater volumes D_r, iterate
  W_v  = f·Π a_r / (f·Π a_r + (1-f)·Π b_r)         (E-step posterior)
  p_r  = Σ W·D_r / Σ W        (sensitivity)        (M-step)
  q_r  = Σ (1-W)(1-D_r) / Σ (1-W)  (specificity)
with the foreground prior f set to the mean foreground fraction of the
raters, to tolerance (max 10000 iterations, matching
staple_filter.SetMaximumIterations, transforms.py:675). The loop runs on
the host and reads the change of p and q from the card once an iteration.
"""

from __future__ import annotations

import torch

#: EM iterations of the last ``staple_binary`` call (read by chip_smoke.py)
last_iterations = 0


def staple_binary(decisions: torch.Tensor, tol: float = 1e-7,
                  max_iterations: int = 10000) -> torch.Tensor:
    """Posterior foreground probability [*(spatial)] (fp32) from a rater
    stack [R, *(spatial)] of {0,1}."""
    global last_iterations
    r = decisions.shape[0]
    d = decisions.reshape(r, -1).float()
    nd = 1.0 - d
    f = torch.clamp(d.mean(), 1e-5, 1.0 - 1e-5)
    log_f, log_nf = torch.log(f), torch.log1p(-f)

    def e_step(p, q):
        # log-domain products for numerical stability
        la = log_f + (d * torch.log(p) + nd * torch.log1p(-p)).sum(dim=0)
        lb = log_nf + (d * torch.log1p(-q) + nd * torch.log(q)).sum(dim=0)
        m = torch.maximum(la, lb)
        ea, eb = torch.exp(la - m), torch.exp(lb - m)
        return ea / (ea + eb)

    p = torch.full((r, 1), 0.99999, dtype=torch.float32, device=d.device)
    q = torch.full((r, 1), 0.99999, dtype=torch.float32, device=d.device)
    w = e_step(p, q)
    for last_iterations in range(1, max_iterations + 1):
        sum_w = w.sum() + 1e-10
        sum_nw = (1 - w).sum() + 1e-10
        new_p = torch.clamp((w[None] * d).sum(dim=1, keepdim=True) / sum_w, 1e-5, 1 - 1e-5)
        new_q = torch.clamp(((1 - w)[None] * nd).sum(dim=1, keepdim=True) / sum_nw,
                            1e-5, 1 - 1e-5)
        delta = torch.maximum((new_p - p).abs().max(), (new_q - q).abs().max())
        p, q = new_p, new_q
        w = e_step(p, q)
        if not delta.item() > tol:
            break
    return w.reshape(decisions.shape[1:])       # the final E-step


def staple_multichannel(members: torch.Tensor, threshold_value: float = 0.5
                        ) -> torch.Tensor:
    """perform_staple_on_brats_multi_channel (transforms.py:650-687): per
    WT/TC/ET channel binary STAPLE over ensemble members, thresholded.

    members: [M, B, X, Y, Z, 3] binarized predictions → [B, X, Y, Z, 3]."""
    if members.shape[1] != 1:
        raise ValueError("For the moment only BS1 is supported")  # transforms.py:653
    chans = [(staple_binary(members[:, 0, ..., c]) > threshold_value).float()
             for c in range(members.shape[-1])]
    return torch.stack(chans, dim=-1)[None]
