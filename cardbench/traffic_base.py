"""What every traffic kind shares: the pool of pairs made from the seed,
the solve seeds, host inputs padded to the configuration's buckets, and the
answers a record holds."""

from __future__ import annotations

import numpy as np

from cardbench.reference.generator import SEED_SPACE, make_pool


class PairTraffic:
    """A traffic kind's base. A record is a dict: "size" and "idx" (the pool
    pairs it sent), "answers" (host numpy valid, scale, rotation,
    translation and count, a leading axis a pair), "latency_s", "t_end",
    and "keep" (the pre-filter's masks over the real columns) where the
    entry point gives them."""

    def __init__(self, run):
        self.run = run
        self.params = run.params
        self.device = run.device
        self.config = run.config
        self.knobs = run.workload["params"]
        self.sizes = list(self.knobs.get("sizes", self.config["sizes"]))
        buckets = dict(zip(self.config["sizes"], self.config["buckets"]))
        self.buckets = {n: buckets[n] for n in self.sizes}
        root = run.seed % SEED_SPACE
        self.solve_rng = np.random.default_rng([root, 1 << 32])
        self.warm_rng = np.random.default_rng([root, 1 << 34])
        self.pool = {}

    def make_pool(self) -> None:
        self.pool = make_pool(self.config, self.run.seed, self.sizes,
                              int(self.knobs["pool_per_size"]))

    def padded(self, n: int):
        """(src, dst, keep) of size n's pool, padded to its bucket: keep 1
        on the real columns and -2 on the padding."""
        pairs, bucket = self.pool[n], self.buckets[n]
        src = np.zeros((len(pairs), 3, bucket), np.float32)
        dst = np.zeros_like(src)
        keep = np.full((len(pairs), bucket), -2, np.int64)
        for j, pair in enumerate(pairs):
            src[j, :, :n], dst[j, :, :n], keep[j, :n] = pair.src, pair.dst, 1
        return src, dst, keep

    def seeds(self, count: int, warm: bool = False) -> list[int]:
        rng = self.warm_rng if warm else self.solve_rng
        return [int(s) for s in rng.integers(0, 1 << 62, size=count)]

    def pair(self, key):
        n, j = key
        return self.pool[n][j]

    def answers(self, rec: dict):
        """(pool key, answer) of each pair of a record."""
        if "answers" not in rec:
            return
        valid, scale, rotation, translation, count = rec["answers"]
        for k, j in enumerate(rec["idx"]):
            answer = {"valid": valid[k], "scale": scale[k], "rotation": rotation[k],
                      "translation": translation[k], "count": count[k]}
            if "keep" in rec:
                answer["keep"] = rec["keep"][k]
            yield (rec["size"], j), answer

    def collect(self) -> None:
        """Bring what the window left on the device to the host."""

    def release(self) -> None:
        """Free the program's plans and their device memory."""
        from psulvsb_tpu_torch.solver.fused import clear_plan_cache

        clear_plan_cache()
