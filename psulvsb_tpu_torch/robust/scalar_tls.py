"""Max-interval stabbing: the translation mode of ScalarTLSEstimator
(registration.cc:121-203) as sort + cumsum, batched over leading dims."""

from __future__ import annotations

import torch

_BIG = 1e30


def max_stabbing(
    x: torch.Tensor,
    noise: torch.Tensor | float,
    active: torch.Tensor | None = None,
    warm_value: torch.Tensor | None = None,
    use_warm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-interval-stabbing estimate over the last dim of x (..., n).

    Each measurement spans [x_i - noise, x_i + noise]. The estimate is the
    mean of the measurements stabbed at the point covered by the most
    intervals. Sweep: sort the 2(n+1) endpoints by (value, starts before
    ends), running count = cumsum(+1/-1); at each end event the count before
    removal is cumsum + 1 and the stabbed sum is cumsum(delta*x) + x. The
    first strict maximum wins, as the reference's `>` does.

    The warm slot (registration.cc:136-161) adds one interval at
    warm_value ± noise when use_warm. Returns (estimate (...), inliers
    (..., n) bool).
    """
    batch = x.shape[:-1]
    if active is None:
        active = torch.ones_like(x, dtype=torch.bool)
    if warm_value is None:
        warm_value = torch.zeros(batch, dtype=x.dtype, device=x.device)
    warm_value = torch.as_tensor(warm_value, dtype=x.dtype, device=x.device)
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)

    xs = torch.cat([x, warm_value.expand(batch)[..., None]], dim=-1)
    warm_act = torch.full(batch + (1,), bool(use_warm), device=x.device)
    act = torch.cat([active, warm_act], dim=-1)

    big = torch.full_like(xs, _BIG)
    vals = torch.cat([torch.where(act, xs - noise, big), torch.where(act, xs + noise, big)], -1)
    one = act.to(x.dtype)
    deltas = torch.cat([one, -one], dim=-1)
    xrep = torch.cat([xs, xs], dim=-1)

    # Lexicographic sort by (value, -delta) with two stable sorts, the
    # secondary key first (jnp.lexsort order).
    o1 = torch.sort(-deltas, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(vals, -1, o1), dim=-1, stable=True).indices
    order = torch.gather(o1, -1, o2)
    deltas_s = torch.gather(deltas, -1, order)
    x_s = torch.gather(xrep, -1, order)

    cnt = torch.cumsum(deltas_s, dim=-1)
    xsum = torch.cumsum(deltas_s * x_s, dim=-1)
    count_at_check = cnt + 1.0
    sum_at_check = xsum + x_s
    score = torch.where(deltas_s < 0, count_at_check, torch.full_like(cnt, -1.0))
    best = torch.argmax(score, dim=-1, keepdim=True)  # first maximum
    estimate = (
        torch.gather(sum_at_check, -1, best)
        / torch.clamp(torch.gather(count_at_check, -1, best), min=1.0)
    )[..., 0]
    inliers = (torch.abs(x - estimate[..., None]) <= noise) & active
    return estimate, inliers
