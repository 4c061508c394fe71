"""One pair a request through `eval.pipeline.solve_with_prefilter` (fused,
the pre-filter on), closed loop with one client: the next request goes when
the last one's pose is in host memory. The sizes in turn from request to
request, the pairs from the pool in turn, a fresh solve seed each.

Parameters: pool_per_size, warmup_calls a size, keep_sample (the requests
whose keep masks the plain pre-filter checks), and optionally sizes."""

from __future__ import annotations

import time

from cardbench.traffic_base import PairTraffic


class Traffic(PairTraffic):
    def setup(self) -> None:
        self.make_pool()
        for n in self.sizes:
            for k in range(int(self.knobs["warmup_calls"])):
                self._call(n, k, self.seeds(1, warm=True)[0])

    def pairs_per_request(self, i: int) -> int:
        return 1

    def _call(self, n: int, k: int, seed: int) -> dict:
        from psulvsb_tpu_torch.eval import pipeline

        j = k % len(self.pool[n])
        pair = self.pool[n][j]
        t0 = time.perf_counter()
        res = pipeline.solve_with_prefilter(pair.src, pair.dst, self.params, seed,
                                            device=self.device)
        host = tuple(field.cpu().numpy()[None] for field in res.solution)
        t1 = time.perf_counter()
        rec = {"size": n, "idx": [j], "answers": host, "latency_s": t1 - t0,
               "elapsed_s": res.elapsed_s, "keep_device": res.keep_mask, "t_end": t1}
        if self.run.trace:
            rec["local_batches"] = self._plan(n).stats["local_batches"]
        return rec

    def request(self, i: int) -> dict:
        n = self.sizes[i % len(self.sizes)]
        return self._call(n, i // len(self.sizes), self.seeds(1)[0])

    def _plan(self, n: int):
        from psulvsb_tpu_torch.solver.fused import plan_for

        return plan_for(self.params, self.buckets[n], self.device)

    def plans(self) -> list:
        return [self._plan(n) for n in self.sizes]

    def collect(self) -> None:
        for rec in self.run.records:
            if "keep_device" in rec:
                rec["keep"] = [rec.pop("keep_device").cpu().numpy()[:rec["size"]]]
