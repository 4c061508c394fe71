"""Scalar robust estimators of ScalarTLSEstimator (registration.cc:53-320),
batched over leading dims:

- `tls_vote`: adaptive-voting TLS (estimate_tiled, registration.cc:206-320)
  as a dense (..., 2N-1, N) grid of interval centers against measurements;
- `scale_consensus_1pt`: the scale mode (registration.cc:67-119), 1-point
  RANSAC over a (..., K, N) grid of draws, with the serial confidence stop
  replayed by a cumulative max;
- `max_stabbing`: the translation mode (registration.cc:121-203) as sort +
  cumsum.
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.utils.precision import mm
from psulvsb_tpu_torch.utils.scalars import as_float32, as_generator, as_scalar

_BIG = 1e30
_GRID_LIMIT = 1 << 27  # entries of one slice of the 1-point consensus grid


def tls_vote(
    x: torch.Tensor,
    ranges: torch.Tensor,
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptive-voting TLS estimate over the last dim of x (..., n).

    The 2n interval endpoints x ± ranges are sorted; each of the 2n-1
    midpoints c_i selects the consensus |x_j - c_i| <= ranges_j, whose
    inverse-variance mean x_hat_i costs sum (x_j - x_hat_i)^2 over the
    consensus plus sum ranges_j outside it (the reference adds plain ranges
    there, registration.cc:261). The least cost wins, the first on ties.
    Inactive endpoints sort last and their centers never win. Returns
    (estimate (...), inliers (..., n))."""
    if active is None:
        active = torch.ones_like(x, dtype=torch.bool)
    big = torch.full_like(x, _BIG)
    h = torch.sort(
        torch.cat([torch.where(active, x - ranges, big), torch.where(active, x + ranges, big)], -1),
        dim=-1,
    ).values
    centers = (h[..., :-1] + h[..., 1:]) / 2.0  # (..., 2n-1)
    act_f = active.to(x.dtype)
    weights = torch.where(active, 1.0 / (ranges * ranges), torch.zeros_like(x))

    diff = torch.abs(x[..., None, :] - centers[..., :, None])  # (..., 2n-1, n)
    cons_f = ((diff <= ranges[..., None, :]) & active[..., None, :]).to(x.dtype)
    dot_xw = mm(cons_f, (x * weights)[..., :, None])[..., 0]
    dot_w = mm(cons_f, weights[..., :, None])[..., 0]
    x_hat = dot_xw / torch.where(dot_w > 0, dot_w, torch.ones_like(dot_w))

    resid = (x[..., None, :] - x_hat[..., :, None]) * cons_f
    sq_cost = (resid * resid * act_f[..., None, :]).sum(-1)
    ranges_out = mm((1.0 - cons_f) * act_f[..., None, :], ranges[..., :, None])[..., 0]
    cost = sq_cost + ranges_out
    ok = (dot_w > 0) & (torch.abs(centers) < _BIG / 2)
    cost = torch.where(ok, cost, torch.full_like(cost, float("inf")))

    best = torch.argmin(cost, dim=-1, keepdim=True)  # first minimum
    estimate = torch.gather(x_hat, -1, best)[..., 0]
    inliers = (torch.abs(x - estimate[..., None]) <= ranges) & active
    return estimate, inliers


def scale_consensus_1pt(
    x: torch.Tensor,
    ranges: torch.Tensor,
    active: torch.Tensor | None = None,
    warm_value: torch.Tensor | None = None,
    use_warm: bool = False,
    max_draws: int = 256,
    confidence: float = 0.99,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-point RANSAC consensus with confidence stopping and weighted
    refinement (registration.cc:67-119) over the last dim of x (..., n).

    K = max_draws candidates are drawn with replacement from the active
    measurements, as jax.random.choice(..., replace=True, p=...) draws
    them: cum = cumsum(p), index = searchsorted(cum, cum[-1] * (1 - u))
    (left side). `u`: optional (..., K) uniforms in [0, 1), so JAX's own
    uniforms give JAX's draws; an all-inactive row draws uniformly. With
    use_warm (a bool, or a 0-d bool tensor selected on the device),
    candidate 0 is `warm_value` (registration.cc:76-86).

    All K consensus counts are scored at once; the serial stop (first t
    with 1 - (1 - best_t / n)^(t+1) >= confidence) is replayed with a
    cumulative max, and the first maximum inside that window wins, as the
    serial loop's strict `>` keeps it. The estimate is the inverse-variance
    mean of the winner's consensus. Returns (estimate (...), inliers
    (..., n))."""
    batch, n = x.shape[:-1], x.shape[-1]
    dev, dtype = x.device, x.dtype
    if active is None:
        active = torch.ones_like(x, dtype=torch.bool)
    n_active = torch.clamp(active.sum(-1), min=1).to(dtype)
    any_active = active.any(-1, keepdim=True)
    probs = torch.where(any_active, active.to(dtype), torch.ones_like(x))
    probs = probs / probs.sum(-1, keepdim=True)
    cum = torch.cumsum(probs, -1)
    if u is None:
        u = torch.rand(batch + (max_draws,), generator=generator, device=dev, dtype=dtype)
    u = u.to(dev, dtype)
    r = cum[..., -1:] * (1.0 - u)
    idx = torch.clamp(torch.searchsorted(cum.contiguous(), r.contiguous(), side="left"), max=n - 1)
    candidates = torch.gather(x, -1, idx)
    k = torch.arange(max_draws, device=dev)
    if warm_value is not None and (isinstance(use_warm, torch.Tensor) or use_warm):
        warm = as_scalar(warm_value, dtype, dev).expand(batch)
        first = (k == 0) & use_warm if isinstance(use_warm, torch.Tensor) else k == 0
        candidates = torch.where(first, warm[..., None], candidates)

    # All K consensus counts; over a long measurement list (the classic
    # solve's complete-graph TIMs) in slices of the draws, so that the
    # (..., K, n) grid never holds more than _GRID_LIMIT entries at once.
    per = max(1, min(max_draws, _GRID_LIMIT // max(n, 1)))
    counts = torch.cat([
        (
            (torch.abs(x[..., None, :] - candidates[..., lo:lo + per, None])
             <= ranges[..., None, :]) & active[..., None, :]
        ).sum(-1)
        for lo in range(0, max_draws, per)
    ], -1).to(dtype)  # (..., K)
    best_so_far = torch.cummax(counts, -1).values
    iters = torch.arange(1, max_draws + 1, device=dev, dtype=dtype)
    conf = 1.0 - torch.pow(1.0 - best_so_far / n_active[..., None], iters)
    reached = conf >= confidence
    first = torch.argmax(reached.to(torch.int64), -1)
    stop_t = torch.where(reached.any(-1), first, torch.full_like(first, max_draws - 1))
    masked = torch.where(k <= stop_t[..., None], counts, torch.full_like(counts, -1.0))
    winner = torch.argmax(masked, -1, keepdim=True)  # first maximum
    estimate0 = torch.gather(candidates, -1, winner)[..., 0]

    inliers = (torch.abs(x - estimate0[..., None]) <= ranges) & active
    w = torch.where(inliers, 1.0 / (ranges * ranges), torch.zeros_like(x))
    sum_left = w.sum(-1)
    sum_right = (w * x).sum(-1)
    refined = torch.where(
        sum_left > 0, sum_right / torch.clamp(sum_left, min=1e-30), estimate0
    )
    return refined, inliers


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
    warm_value ± noise when use_warm (a bool or a 0-d bool tensor). Returns (estimate (...), inliers
    (..., n) bool).
    """
    batch = x.shape[:-1]
    if active is None:
        active = torch.ones_like(x, dtype=torch.bool)
    if warm_value is None:
        warm_value = torch.zeros(batch, dtype=x.dtype, device=x.device)
    warm_value = as_scalar(warm_value, x.dtype, x.device)
    noise = as_scalar(noise, x.dtype, x.device)

    xs = torch.cat([x, warm_value.expand(batch)[..., None]], dim=-1)
    if isinstance(use_warm, torch.Tensor):
        warm_act = use_warm.expand(batch + (1,))
    else:
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


class ScalarTLSEstimator:
    """Facade of teaser::ScalarTLSEstimator (registration.h:107-133).
    `estimate` gives the PSULVSB fork's two modes through explicit arguments
    in place of the reference's STswitch/first_time globals
    (registration.cc:41-42); `estimate_tiled` is stock adaptive voting.

    The inputs are moved to `device` as float32: the card unless the caller
    asks for the CPU. The scale mode draws from `generator` (a
    torch.Generator on `device`, or an int seed), or from the uniforms `u`
    a call passes in (JAX's own give JAX's draws)."""

    def __init__(self, generator=0, device="cuda"):
        self.device = torch.device(device)
        self._gen = as_generator(generator, self.device)

    def estimate(self, x, ranges, mode: str = "scale", warm_value=None, noise=None, u=None):
        """mode="scale": 1-point RANSAC consensus (the STswitch == 0 path);
        mode="translation": max-interval stabbing (STswitch >= 1; `noise` is
        the per-axis translation noise, by default ranges[0]). A warm value
        takes the first draw (registration.cc:76-86, 136-161). Returns
        (estimate, inlier mask)."""
        x = as_float32(x, self.device)
        ranges = as_float32(ranges, self.device)
        warm = None if warm_value is None else as_float32(warm_value, self.device)
        if mode == "scale":
            return scale_consensus_1pt(
                x, ranges, warm_value=warm, use_warm=warm is not None, u=u, generator=self._gen,
            )
        if mode == "translation":
            n = ranges[0] if noise is None else as_float32(noise, self.device)
            return max_stabbing(x, n, warm_value=warm, use_warm=warm is not None)
        raise ValueError(f"unknown mode {mode!r}")

    def estimate_tiled(self, x, ranges, s: int = 64):
        """Stock TEASER adaptive voting (registration.cc:206-320). The tile
        size `s` is a CPU cache-blocking knob of the reference; it is taken
        for the signature's sake and ignored."""
        del s
        return tls_vote(as_float32(x, self.device), as_float32(ranges, self.device))
