"""Bulk registration: calls of B pairs of one size through
`parallel.pairs.register_batch`, in order or batched (`vectorized`), the
sizes in turn from call to call. The pairs come from the pool in turn, each
with a fresh solve seed; host numpy inputs padded to the bucket, keep 1 on
the real columns and -2 on the padding, no pre-filter. A call ends with its
poses in host memory.

Parameters: batch (B), vectorized, pool_per_size, warmup_calls a size, and
optionally sizes (a subset of the configuration's)."""

from __future__ import annotations

import time

import numpy as np

from cardbench.traffic_base import PairTraffic


class Traffic(PairTraffic):
    def setup(self) -> None:
        self.batch = int(self.knobs["batch"])
        self.vectorized = bool(self.knobs["vectorized"])
        self.make_pool()
        self.inputs = {n: self.padded(n) for n in self.sizes}
        for n in self.sizes:
            for k in range(int(self.knobs["warmup_calls"])):
                self._call(n, k, self.seeds(self.batch, warm=True))

    def pairs_per_request(self, i: int) -> int:
        return self.batch

    def _call(self, n: int, k: int, seeds: list[int]) -> dict:
        from psulvsb_tpu_torch.parallel import pairs

        idx = (k * self.batch + np.arange(self.batch)) % len(self.pool[n])
        src, dst, keep = (a[idx] for a in self.inputs[n])
        t0 = time.perf_counter()
        sol = pairs.register_batch(src, dst, keep, seeds, self.params,
                                   vectorized=self.vectorized, device=self.device)
        host = tuple(field.cpu().numpy() for field in sol)
        t1 = time.perf_counter()
        return {"size": n, "idx": idx.tolist(), "answers": host, "latency_s": t1 - t0,
                "t_end": t1}

    def request(self, i: int) -> dict:
        n = self.sizes[i % len(self.sizes)]
        return self._call(n, i // len(self.sizes), self.seeds(self.batch))

    def plans(self) -> list:
        from psulvsb_tpu_torch.parallel.pairs import pairs_per_chunk
        from psulvsb_tpu_torch.solver.fused import plan_for

        if self.vectorized:
            return [plan_for(self.params, c, self.device,
                             pairs=pairs_per_chunk(c, self.batch, self.device, self.params))
                    for c in self.buckets.values()]
        return [plan_for(self.params, c, self.device) for c in self.buckets.values()]
