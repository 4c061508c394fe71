"""The plain reference that decides `correct`, in float64 numpy.

Each answer of the program is a pose s (R p + t), its validity and its
inlier count. It is judged by what it says, against the pair as the
benchmark made it:

- `orth_err`: R is a rotation, max(|R^T R - I|, |det R - 1|);
- `scale_err`: |s - sigma|, sigma the pair's test scale (`Pair.scale`, 1 at
  known scale, where s has to be 1);
- `missed`: the pose is an answer to this pair: its count reaches half of
  the consensus of the true pose (sigma (R p + t), over the columns the
  pre-filter kept, where it ran);
- `filtered`: the pre-filter kept under half of the true pose's consensus,
  so the solve had no answer to find; such an answer is judged by its keep
  mask (against the plain pre-filter, on a sample) and by recall, and not
  by the numbers below;
- `count_off`, for an answer not missed: its count is off the consensus of
  its pose (the correspondences within the solver's inlier threshold of
  it, registration.cc:669, :1417-1444) by more than COUNT_TOL of the larger.
  The solver counts the host best before its final refinement, which starts
  from the last round's sampled best and is kept where it fits the final
  inliers better (registration.cc:1502-1525), so a sound answer's count may
  stray from its pose's consensus now and then; a fault moves every answer;
- `rot_gap_deg`, `trans_gap`, for an answer neither missed nor filtered:
  the angle between its rotation and the reference pose's, and the distance
  between their translations, where the reference pose is the float64
  least-squares fit (Kabsch; Umeyama's similarity at a test scale) over the
  correspondences that the true pose explains (reference/oracle.py). Their
  medians over a window's answers see the precision of the arithmetic,
  which a rotation made orthonormal again before it is returned would hide
  from `orth_err`: most sound
  answers fit the same inliers and meet the reference to float32 rounding,
  while a few fit an inlier set that differs by a column or two and stray
  by up to some hundredths of a degree, as far as bfloat16 arithmetic moves
  every answer; so the widest gap does not tell the two apart.

A keep mask of the pre-filter is off where it differs from the plain
pre-filter's in more than KEEP_TOL of its columns. Not the widest gap: one
point that moves between two bins can tip a bin across the mean + 1 sigma
height test, and the whole bin's points change between kept and held back
(a sound run read 8.4% of one pair's columns so, measured on one H100).

`recall` is the registration criterion (teaser_cpp_ply_main.cc:424, :714)
against the generator's truth, with the answer's translation in the
truth's units, s t / sigma (as the port's `score_pose` has it), and, where
the criteria give `max_scale_err`, |s - sigma| within it (:319-424).
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

COUNT_TOL = 0.05  # a count off its pose's consensus by more than this share is off
KEEP_TOL = 0.01  # a keep mask differing in more than this share of columns is off


def inlier_threshold(noise_bound: float, keep: np.ndarray) -> float:
    """The solver's threshold 2 nb (1 + |kept| / |real|) over the real
    columns' keep mask (1 kept, 0 held back, -1 filtered out)."""
    keep = np.asarray(keep)
    return 2.0 * noise_bound * (1.0 + float((keep == 1).sum()) / max(keep.size, 1))


def residuals(src, dst, scale, rotation, translation) -> np.ndarray:
    """|dst - s (R src + t)| of each column, in float64."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    moved = float(scale) * (np.asarray(rotation, np.float64) @ src
                            + np.asarray(translation, np.float64)[:, None])
    return np.sqrt(((dst - moved) ** 2).sum(0))


def consensus(src, dst, scale, rotation, translation, threshold: float) -> int:
    return int((residuals(src, dst, scale, rotation, translation) <= threshold).sum())


def orth_err(rotation) -> float:
    r = np.asarray(rotation, np.float64)
    if not np.all(np.isfinite(r)):
        return float("inf")
    return float(max(np.abs(r.T @ r - np.eye(3)).max(), abs(np.linalg.det(r) - 1.0)))


def pose_gap(answer: dict, reference: dict) -> tuple[float, float]:
    """(degrees between the two rotations, distance between the two
    translations) of two poses at scale 1: an answer's errors against the
    truth, or its gaps to the reference fit. The angle from the chord,
    |A - B|_F = 2 sqrt(2) sin(angle / 2), which keeps its digits near 0
    where the trace's arccos loses them."""
    a = np.asarray(reference["rotation"], np.float64)
    b = np.asarray(answer["rotation"], np.float64)
    chord = np.linalg.norm(a - b) / (2.0 * np.sqrt(2.0))
    return (float(np.degrees(2.0 * np.arcsin(min(chord, 1.0)))),
            float(np.linalg.norm(np.asarray(answer["translation"], np.float64)
                                 - np.asarray(reference["translation"], np.float64))))


def judge(pair, answer: dict, threshold: float, true_consensus: int, criteria: dict,
          reference: dict, kept_consensus: int | None = None) -> dict:
    """One answer's readings. `answer`: valid, scale, rotation (3, 3),
    translation (3,), count; `true_consensus`: the consensus of the truth
    (at the pair's scale) at `threshold`; `reference`: the float64 fit over
    the truth's inliers (scale, rotation, translation); `kept_consensus`:
    the truth's consensus over the columns the pre-filter kept, where it
    ran."""
    finite = all(np.all(np.isfinite(np.asarray(answer[k], np.float64)))
                 for k in ("scale", "rotation", "translation"))
    count = int(answer["count"])
    sigma = float(pair.scale)
    scale = float(answer["scale"])
    if finite:
        ref = consensus(pair.src, pair.dst, answer["scale"], answer["rotation"],
                        answer["translation"], threshold)
        re, te = pose_gap({"rotation": answer["rotation"],
                           "translation": scale * np.asarray(answer["translation"],
                                                             np.float64) / sigma},
                          {"rotation": pair.rotation, "translation": pair.translation})
    else:
        ref, re, te = -1, float("inf"), float("inf")
    scale_err = abs(scale - sigma) if finite else float("inf")
    filtered = kept_consensus is not None and kept_consensus < 0.5 * true_consensus
    found = true_consensus if kept_consensus is None else kept_consensus
    missed = None if filtered else (not bool(answer["valid"])) or count < 0.5 * found
    rot_gap, trans_gap = (None, None) if filtered or missed else (
        pose_gap(answer, reference) if finite else (float("inf"), float("inf")))
    return {
        "finite": finite,
        "orth_err": orth_err(answer["rotation"]),
        "scale_err": scale_err,
        "filtered": filtered,
        "missed": missed,
        "count_off": None if filtered or missed else
        abs(count - ref) > COUNT_TOL * max(count, ref, 1),
        "rot_gap_deg": rot_gap,
        "trans_gap": trans_gap,
        "recall": re <= criteria["max_rot_deg"] and te <= criteria["max_trans"]
        and scale_err <= criteria.get("max_scale_err", float("inf")),
    }


def keep_off(program_keep, reference_keep) -> bool:
    return float((np.asarray(program_keep) != np.asarray(reference_keep)).mean()) > KEEP_TOL
