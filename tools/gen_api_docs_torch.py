"""Generate docs/API_torch.md — a markdown reference of the public surface
of the PyTorch/CUDA port, `psulvsb_tpu_torch`.

The sections mirror tools/gen_api_docs.py's over the JAX package, module
for module; the kernel sections name the CUDA front doors (`ops/gnc.py`,
`ops/hist.py`, `ops/pairs.py`) in place of the Pallas modules. Signatures
and first-paragraph docstrings come from the code. It imports the port only
(no JAX). Regenerate after API changes:

    python tools/gen_api_docs_torch.py

tests/test_torch_entry.py holds the committed file to a fresh generation.
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "docs", "API_torch.md")

# (title, module, [names]) — None means use __all__ or all public
# callables/classes defined in the module.
SECTIONS: list[tuple[str, str, list[str] | None]] = [
    ("Top-level API", "psulvsb_tpu_torch", None),
    ("Solver facade & functional API", "psulvsb_tpu_torch.api", None),
    ("Solver configuration", "psulvsb_tpu_torch.solver.config",
     ["SolverParams", "RotationEstimationAlgorithm", "InlierSelectionMode",
      "InlierGraphFormulation"]),
    ("Solution type", "psulvsb_tpu_torch.solver.solution", ["RegistrationSolution"]),
    ("Staged solver", "psulvsb_tpu_torch.solver.psulvsb",
     ["psulvsb_solve", "write_iteration_stats"]),
    ("Fused solver (replayed CUDA graphs)", "psulvsb_tpu_torch.solver.fused",
     ["psulvsb_register", "plan_for", "clear_plan_cache"]),
    ("Basic (classic RANSAC) solvers", "psulvsb_tpu_torch.solver.basic", None),
    ("Classic TEASER pipeline", "psulvsb_tpu_torch.solver.classic", None),
    ("Scalar TLS estimation", "psulvsb_tpu_torch.robust.scalar_tls", None),
    ("Scale solvers", "psulvsb_tpu_torch.robust.scale", None),
    ("Translation solver", "psulvsb_tpu_torch.robust.translation", None),
    ("GNC-TLS rotation", "psulvsb_tpu_torch.rotation.gnc", None),
    ("Fast Global Registration rotation", "psulvsb_tpu_torch.rotation.fgr", None),
    ("DRS certification", "psulvsb_tpu_torch.certify.drs", None),
    ("Graph & max-clique", "psulvsb_tpu_torch.clique.graph", None),
    ("k-core / greedy clique", "psulvsb_tpu_torch.clique.kcore", None),
    ("PMC-equivalent native solver", "psulvsb_tpu_torch.clique.pmc", None),
    ("GROR initializer", "psulvsb_tpu_torch.gror.gror", None),
    ("FPFH features", "psulvsb_tpu_torch.frontend.fpfh", None),
    ("Feature matcher", "psulvsb_tpu_torch.frontend.matcher", None),
    ("Normals", "psulvsb_tpu_torch.frontend.normals", None),
    ("kNN", "psulvsb_tpu_torch.frontend.knn", None),
    ("Voxel downsampling", "psulvsb_tpu_torch.frontend.voxel", None),
    ("ISS keypoints", "psulvsb_tpu_torch.frontend.iss", None),
    ("ICP refinement", "psulvsb_tpu_torch.frontend.icp", None),
    ("Normal-angle histogram prefilter",
     "psulvsb_tpu_torch.frontend.histogram_filter", None),
    ("PLY I/O", "psulvsb_tpu_torch.io.ply", None),
    ("Core geometry / SE(3)", "psulvsb_tpu_torch.core.se3", None),
    ("Core linalg", "psulvsb_tpu_torch.core.linalg", None),
    ("Metrics", "psulvsb_tpu_torch.core.metrics", None),
    ("Pair batches across cards", "psulvsb_tpu_torch.parallel.pairs", None),
    ("CUDA kernel front door: GNC (csrc/gnc_batch.cu)", "psulvsb_tpu_torch.ops.gnc", None),
    ("CUDA kernel front doors: histograms / pair counts "
     "(csrc/pair_ratio_hist.cu, csrc/pair_beta_count.cu)", "psulvsb_tpu_torch.ops.hist", None),
    ("CUDA kernel front door: pairwise ops (csrc/consistency_degree.cu)",
     "psulvsb_tpu_torch.ops.pairs", None),
    ("Batched dataset harness", "psulvsb_tpu_torch.eval.batch_harness", None),
    ("Serial dataset harness", "psulvsb_tpu_torch.eval.realdata", None),
    ("Dataset generator", "psulvsb_tpu_torch.eval.make_dataset", None),
    ("Correspondence generation", "psulvsb_tpu_torch.eval.corr_gen", None),
    ("Raw-cloud pipeline", "psulvsb_tpu_torch.eval.pipeline", None),
    ("Real-scan registration", "psulvsb_tpu_torch.eval.realscan", None),
    ("Synthetic fixtures", "psulvsb_tpu_torch.eval.synthetic", None),
    ("Protocol runner", "psulvsb_tpu_torch.eval.protocol", None),
    ("Reporting", "psulvsb_tpu_torch.eval.reporting", None),
    ("Padding utilities", "psulvsb_tpu_torch.utils.padding", None),
    ("Timing utilities", "psulvsb_tpu_torch.utils.timing", None),
    ("Precision helpers", "psulvsb_tpu_torch.utils.precision", None),
    ("CLI (MATLAB bridge)", "psulvsb_tpu_torch.cli", None),
]


def _first_para(doc: str | None) -> str:
    if not doc:
        return ""
    return inspect.cleandoc(doc).split("\n\n")[0].replace("\n", " ")


def _public_names(mod) -> list[str]:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [
        n for n, obj in vars(mod).items()
        if not n.startswith("_")
        and (inspect.isfunction(obj) or inspect.isclass(obj))
        and getattr(obj, "__module__", None) == mod.__name__
    ]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def render() -> str:
    lines = [
        "# psulvsb_tpu_torch API reference",
        "",
        "Generated by `tools/gen_api_docs_torch.py` — do not edit by hand.",
        "",
        "The PyTorch/CUDA port of `psulvsb_tpu` (docs/API.md): the same modules and names, "
        "imports torch and numpy only. Entry points run on the CUDA card unless the caller "
        "asks for the CPU (`device=\"cpu\"`, `--device cpu`); four hand-written CUDA kernels "
        "(`psulvsb_tpu_torch/csrc/`) sit behind the `ops` front doors. Install nothing: the "
        "package runs from the repo root. Entry points below are grouped by subsystem.",
        "",
    ]
    for title, modname, names in SECTIONS:
        mod = importlib.import_module(modname)
        lines.append(f"## {title} — `{modname}`")
        lines.append("")
        para = _first_para(mod.__doc__)
        if para:
            lines.append(para)
            lines.append("")
        for name in names if names is not None else _public_names(mod):
            obj = getattr(mod, name, None)
            if obj is None:
                continue
            if inspect.isclass(obj):
                lines.append(f"### class `{name}`")
                lines.append("")
                p = _first_para(obj.__doc__)
                if p and not p.startswith(name + "("):  # skip namedtuple auto-doc
                    lines.append(p)
                    lines.append("")
                fields = getattr(obj, "_fields", None)
                if fields:
                    lines.append("Fields: " + ", ".join(f"`{f}`" for f in fields))
                    lines.append("")
                for mname, meth in inspect.getmembers(obj, inspect.isfunction):
                    if mname.startswith("_") or meth.__qualname__.split(".")[0] != name:
                        continue
                    lines.append(f"- `{name}.{mname}{_sig(meth)}`")
                    mp = _first_para(meth.__doc__)
                    if mp:
                        lines.append(f"  — {mp}")
                lines.append("")
            elif inspect.isfunction(obj):
                lines.append(f"### `{name}{_sig(obj)}`")
                lines.append("")
                p = _first_para(obj.__doc__)
                if p:
                    lines.append(p)
                    lines.append("")
            else:
                # Constants etc. — name only; a repr may embed addresses.
                lines.append(f"### `{name}`")
                lines.append("")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    with open(OUT, "w") as f:
        f.write(render())
    print(f"wrote {os.path.relpath(OUT, ROOT)}")
